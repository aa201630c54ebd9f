"""The MoE kernels and their plain PyTorch versions: B12
``mx_grouped_matmul``, the dropless grouped expert GEMM
(``csrc/mx_grouped_matmul.cu``), and ``mx_router_logits``, the router's
row-wise product in bf16 or f32 (``csrc/mx_router.cu``).

B12 replaces ``torchmx_tpu/ops/pallas_moe.py::_grouped_kernel_bf16``,
``_grouped_kernel_tinner`` and ``_grouped_kernel_mx`` (``grouped_matmul``):
``x_sorted (R, K) bf16`` (rows sorted by expert, each expert's group padded
to a multiple of ``tm``) times the stacked expert weights ``(E, K, N)``,
where row tile ``t`` contracts with expert ``tile_expert[t]``; fp32
accumulation, one bf16 rounding.  The weights are bf16 (``elem_name`` None)
or one-byte MX codes (fp8 e4m3, fp6 e3m2 / e2m3 flat, int8) with E8M0 scales
``(E, K/32, N)``, decoded as dot operands as B6 decodes them.

Rows at or past ``tile_rows[t]`` in tile ``t`` come out as 0 (the dead
tiles have ``tile_rows[t] == 0``), as in the JAX kernel, and so do the rows
of a tile past ``max_rows``: the caller's bound on the rows any expert holds
(the MoE block passes its token count, :func:`~.moe.row_bounds`).
``group_tokens`` pads each group to ``tm`` rows of zeros, so with a true
bound this is the unbounded result; the kernel then multiplies only a box
of rows sized to the bound (:func:`plan_grouped`), so a decode step's tile of
128 rows costs the work of its few tokens.

``tile_expert`` and ``tile_rows`` stay on the device: the kernel reads them
there (as Pallas prefetches them), and nothing here synchronises with the
host.  The plain version reads them back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import cuda_lib
from .backend import on_cuda
from .cuda_matmul import k_splits, sm_count
from .cuda_matmul_formats import CODE_FORMATS_1BYTE, mx_matmul_1byte_plain
from .cuda_norm import pairwise_sum

GROUPED_FORMATS = (None,) + CODE_FORMATS_1BYTE  # None: bf16 experts
B12_BN = 128  # columns of W a CTA: two warpgroups of 64
B12_MAX_SB = 128  # rows of a row block at most
B12_NB = (16, 32, 64, 128)  # the x rows a CTA can take: wgmma m64n{nb}k16
# Planted faults of the kernel, for the model check only: W's row coordinate
# one MX block late, a live tile's extent one row short.
B12_FAULTS = {"expert K offset one block late": 1, "extent one row short": 2}


def check_grouped_operands(x, w, tile_expert, tile_rows, tm: int, w_scale, elem_name) -> None:
    """Raise unless the operands fit together: x (R, K) bf16 with R a
    multiple of tm, w (E, K, N) bf16 (``elem_name`` None) or one-byte codes
    (int8 for ``"int8"``, else uint8) with a (E, K/32, N) uint8 scale, and
    int32 ``tile_expert`` / ``tile_rows`` of R/tm entries; all contiguous."""
    if elem_name not in GROUPED_FORMATS:
        raise ValueError(f"the grouped kernel takes weight formats {GROUPED_FORMATS}, got {elem_name!r}")
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be a 2-D bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    R, K = x.shape
    if w.dim() != 3 or w.shape[1] != K:
        raise ValueError(f"w must be (E, {K}, N), got {tuple(w.shape)}")
    E, _, N = w.shape
    if tm <= 0 or R % tm:
        raise ValueError(f"the row count {R} must be a multiple of tm={tm}")
    w_dtype = torch.bfloat16 if elem_name is None else torch.int8 if elem_name == "int8" else torch.uint8
    if w.dtype != w_dtype:
        raise ValueError(f"{elem_name or 'bf16'} experts are {w_dtype}, got {w.dtype}")
    if (w_scale is None) != (elem_name is None):
        raise ValueError("w_scale is given exactly for code formats")
    if w_scale is not None and (w_scale.shape != (E, K // 32, N) or w_scale.dtype != torch.uint8 or K % 32):
        raise ValueError(f"w_scale must be ({E}, {K // 32}, {N}) uint8, got {w_scale.dtype} {tuple(w_scale.shape)}")
    for name, t in (("tile_expert", tile_expert), ("tile_rows", tile_rows)):
        if t.shape != (R // tm,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({R // tm},) int32, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (x, w, tile_expert, tile_rows) + (() if w_scale is None else (w_scale,))):
        raise ValueError("the grouped kernel's operands must be contiguous")


def tile_extent(tm: int, max_rows: Optional[int]) -> int:
    """The rows of a tile that can be live: ``min(max_rows, tm)``, all ``tm``
    without a bound."""
    if max_rows is None:
        return tm
    if max_rows < 1:
        raise ValueError(f"max_rows must be at least 1, got {max_rows}")
    return min(max_rows, tm)


def mx_grouped_matmul_plain(x, w, tile_expert, tile_rows, tm: int, w_scale=None,
                            elem_name: Optional[str] = None, max_rows: Optional[int] = None,
                            max_experts: Optional[int] = None) -> torch.Tensor:
    """Plain version of B12: for each live tile, its first ``min(tile_rows[t],
    max_rows, tm)`` rows times its expert's weight (an fp32 matmul for bf16
    experts, the plain B6 without act fq for codes); every other row 0.
    ``max_experts`` only steers the kernel's plan."""
    check_grouped_operands(x, w, tile_expert, tile_rows, tm, w_scale, elem_name)
    ext = tile_extent(tm, max_rows)
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.bfloat16, device=x.device)
    for t, (e, n) in enumerate(zip(tile_expert.tolist(), tile_rows.tolist())):
        n = min(n, ext)
        if n <= 0 or not 0 <= e < w.shape[0]:
            continue
        rows = slice(t * tm, t * tm + n)
        if elem_name is None:
            out[rows] = (x[rows].to(torch.float32) @ w[e].to(torch.float32)).to(torch.bfloat16)
        else:
            out[rows] = mx_matmul_1byte_plain(x[rows], w[e], w_scale[e], elem_name, None)
    return out


class GroupedPlan(NamedTuple):
    """B12's launch plan."""

    sb: int  # rows of a row block (a CTA's rows of x): min(tm, 128)
    ext: int  # rows of a tile that can be live: min(max_rows, tm)
    nb: int  # rows of the CTA's x box and wgmma's n: the smallest of B12_NB covering min(ext, sb)
    splits: int  # K splits: k_splits(N, K), B6's
    walk: bool  # each CTA walks its splits: one launch, no workspace
    ws_shape: tuple  # the fp32 workspace of the two-pass form, () when walking


def plan_grouped(R: int, N: int, K: int, tm: int, sms: int, max_rows: Optional[int] = None,
                 max_experts: Optional[int] = None) -> GroupedPlan:
    """B12's plan.  The splits are B6's, a function of N and K alone.  The
    live row blocks are at most ``max_experts`` experts' (each spanning
    ``ceil(max_rows / tm)`` tiles of ``ceil(ext / sb)`` live blocks), and at
    most all ``R / sb``; where they make half a wave of 128-column tiles or
    more, each CTA walks its splits (one launch), else one split a CTA into
    a workspace of ``nb`` rows a row block, summed by a second kernel."""
    sb = min(tm, B12_MAX_SB)
    ext = tile_extent(tm, max_rows)
    nb = next(n for n in B12_NB if n >= min(ext, sb))
    splits = k_splits(N, K, sms)
    blocks = R // sb
    if max_experts is not None:
        per_expert = (-(-max_rows // tm) if max_rows is not None else R // tm) * -(-ext // sb)
        blocks = min(blocks, max_experts * per_expert)
    walk = splits == 1 or 2 * blocks * -(-N // B12_BN) >= sms
    return GroupedPlan(sb, ext, nb, splits, walk, () if walk else (splits, R // sb, nb, N))


def mx_grouped_matmul(x, w, tile_expert, tile_rows, tm: int, w_scale=None, elem_name: Optional[str] = None,
                      max_rows: Optional[int] = None, max_experts: Optional[int] = None,
                      fault: int = 0) -> torch.Tensor:
    """B12: ``(R, N)`` bf16.  CUDA tensors launch the kernel (N and K
    multiples of 64; tm a multiple of 8, and of 128 above 128); CPU tensors
    run the plain version.  ``max_rows``: no expert holds more rows (rows of
    a tile past it come out as 0); ``max_experts``: no more experts are live
    (the plan's hint).  ``fault`` (a value of ``B12_FAULTS``) plants a fault
    in the kernel for the model check; the package never sets it."""
    if not on_cuda(x, w, tile_expert, tile_rows, w_scale):
        return mx_grouped_matmul_plain(x, w, tile_expert, tile_rows, tm, w_scale, elem_name, max_rows, max_experts)
    check_grouped_operands(x, w, tile_expert, tile_rows, tm, w_scale, elem_name)
    (R, K), (E, _, N) = x.shape, w.shape
    if K % 64 or N % 64 or tm % 8 or (tm > B12_MAX_SB and tm % B12_MAX_SB):
        raise ValueError(f"the grouped kernel needs K % 64 == 0, N % 64 == 0 and tm a multiple of 8 (of 128 "
                         f"above 128), got K={K} N={N} tm={tm}")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if w_scale is None else (w_scale,))):
        raise ValueError("the grouped kernel reads x, the weights and the scales by TMA: their storage must be "
                         "16-byte aligned")
    if fault not in (0, *B12_FAULTS.values()):
        raise ValueError(f"fault must be 0 or one of {B12_FAULTS}, got {fault}")
    plan = plan_grouped(R, N, K, tm, sm_count(x.device), max_rows, max_experts)
    out = torch.empty((R, N), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty(plan.ws_shape, dtype=torch.float32, device=x.device) if plan.ws_shape else None
    elem = -1 if elem_name is None else cuda_lib.ELEM_CODES[elem_name]
    cuda_lib.launch("mx_grouped_matmul", "mx_grouped_matmul_launch", x.data_ptr(), w.data_ptr(),
                    0 if w_scale is None else w_scale.data_ptr(), tile_expert.data_ptr(), tile_rows.data_ptr(),
                    out.data_ptr(), 0 if ws is None else ws.data_ptr(), R, N, K, E, tm, elem, plan.ext, plan.nb,
                    plan.splits, int(plan.walk), fault)
    return out


ROUTER_CHUNK = 256  # elements of a row summed by one pairwise tree (csrc/mx_router.cu)
ROUTER_MAX_E = 256


def mx_router_logits_plain(x: torch.Tensor, w: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """``x @ w.T`` in the kernel's order, bit for bit: the exact f32
    products of each chunk of ``ROUTER_CHUNK`` elements summed by a pairwise
    tree, the chunk sums added in chunk order (the tail of a row not a chunk
    multiple forms a last, shorter chunk); one bf16 rounding, or none with
    ``f32``.  A row's result does not depend on the other rows."""
    T, H = x.shape
    E = w.shape[0]
    wf = w.to(torch.float32)
    out = torch.empty((T, E), dtype=torch.float32, device=x.device)
    step = max(1, (1 << 26) // max(1, E * H))  # rows per pass: bounds the (rows, E, H) products
    for r0 in range(0, T, step):
        p = x[r0:r0 + step].to(torch.float32)[:, None, :] * wf[None]
        acc = torch.zeros(p.shape[:2], dtype=torch.float32, device=x.device)
        for c0 in range(0, H, ROUTER_CHUNK):
            acc = acc + pairwise_sum(p[..., c0:c0 + ROUTER_CHUNK])
        out[r0:r0 + step] = acc
    return out if f32 else out.to(x.dtype)


def mx_router_logits(x: torch.Tensor, w: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """The router's logits ``(T, E)`` from ``x (T, H)`` and the router
    weight ``w (E, H)`` (torch layout), both bf16: rounded to bf16
    (Mixtral), or f32 with ``f32`` (DeepSeek-V3's sigmoid router).  It
    replaces no TPU kernel (the JAX router is a plain jnp matmul); on the
    card it repairs the port's row invariance: cuBLAS sums a row in another
    order at other row counts, which moved a token's logits, and at a near
    tie its experts, with the number of tokens in the call.  The kernel sums
    each row in the plain version's fixed order (H a multiple of 256, up to
    256 experts)."""
    if not on_cuda(x, w):
        return mx_router_logits_plain(x, w, f32)
    (T, H), E = x.shape, w.shape[0]
    if x.dim() != 2 or x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.shape != (E, H) \
            or H % ROUTER_CHUNK or not 1 <= E <= ROUTER_MAX_E:
        raise ValueError(f"the router kernel takes bf16 x (T, H) and w (E, H) with H % {ROUTER_CHUNK} == 0 and "
                         f"1 <= E <= {ROUTER_MAX_E}, got {x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((T, E), dtype=torch.float32 if f32 else torch.bfloat16, device=x.device)
    cuda_lib.launch("mx_router", "mx_router_logits_launch", x.data_ptr(), w.data_ptr(), out.data_ptr(), T, H, E,
                    int(f32))
    return out
