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
tiles have ``tile_rows[t] == 0``), as in the JAX kernel.  ``group_tokens``
counts each expert's padding rows (zeros of x) among the live ones; the
kernel finds the all-zero rows of x in a first pass and neither loads nor
multiplies them (their outputs are 0 for any finite weight), so a decode
step's tile of 128 rows costs the work of its few tokens.

``tile_expert`` and ``tile_rows`` stay on the device: the kernel reads them
there (as Pallas prefetches them), and nothing here synchronises with the
host.  The plain version reads them back.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .backend import on_cuda
from .cuda_matmul import _plan
from .cuda_matmul_formats import CODE_FORMATS_1BYTE, mx_matmul_1byte_plain
from .cuda_norm import pairwise_sum

GROUPED_FORMATS = (None,) + CODE_FORMATS_1BYTE  # None: bf16 experts


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


def mx_grouped_matmul_plain(x, w, tile_expert, tile_rows, tm: int, w_scale=None,
                            elem_name: Optional[str] = None) -> torch.Tensor:
    """Plain version of B12: for each live tile, its live rows times its
    expert's weight (an fp32 matmul for bf16 experts, the plain B6 without
    act fq for codes); every other row 0."""
    check_grouped_operands(x, w, tile_expert, tile_rows, tm, w_scale, elem_name)
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.bfloat16, device=x.device)
    for t, (e, n) in enumerate(zip(tile_expert.tolist(), tile_rows.tolist())):
        n = min(n, tm)
        if n <= 0 or not 0 <= e < w.shape[0]:
            continue
        rows = slice(t * tm, t * tm + n)
        if elem_name is None:
            out[rows] = (x[rows].to(torch.float32) @ w[e].to(torch.float32)).to(torch.bfloat16)
        else:
            out[rows] = mx_matmul_1byte_plain(x[rows], w[e], w_scale[e], elem_name, None)
    return out


def mx_grouped_matmul(x, w, tile_expert, tile_rows, tm: int, w_scale=None,
                      elem_name: Optional[str] = None) -> torch.Tensor:
    """B12: ``(R, N)`` bf16.  CUDA tensors launch the kernel (N and K
    multiples of 64; tm a multiple of 8, and of 128 above 128); CPU tensors
    run the plain version."""
    if not on_cuda(x, w, tile_expert, tile_rows, w_scale):
        return mx_grouped_matmul_plain(x, w, tile_expert, tile_rows, tm, w_scale, elem_name)
    check_grouped_operands(x, w, tile_expert, tile_rows, tm, w_scale, elem_name)
    (R, K), (E, _, N) = x.shape, w.shape
    if K % 64 or N % 64 or tm % 8 or (tm > 128 and tm % 128):
        raise ValueError(f"the grouped kernel needs K % 64 == 0, N % 64 == 0 and tm a multiple of 8 (of 128 "
                         f"above 128), got K={K} N={N} tm={tm}")
    _, splits = _plan(R, N, K, x.device)
    out = torch.empty((R, N), dtype=torch.bfloat16, device=x.device)
    marked = torch.empty((R,), dtype=torch.int32, device=x.device)
    ws = torch.empty((splits, R, N) if splits > 1 else (1,), dtype=torch.float32, device=x.device)
    elem = -1 if elem_name is None else cuda_lib.ELEM_CODES[elem_name]
    scale_ptr = 0 if w_scale is None else w_scale.data_ptr()
    cuda_lib.launch("mx_grouped_matmul", "mx_grouped_matmul_launch", x.data_ptr(), w.data_ptr(), scale_ptr,
                    tile_expert.data_ptr(), tile_rows.data_ptr(), marked.data_ptr(), out.data_ptr(), ws.data_ptr(),
                    R, N, K, E, tm, elem, splits)
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
