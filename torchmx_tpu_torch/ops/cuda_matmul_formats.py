"""The matmul kernels for the one-byte, fp6-quarters and int8-dot weight
layouts, and their plain PyTorch versions:

* B6 ``mx_matmul_1byte`` (``csrc/mx_matmul_1byte.cu``) replaces
  ``torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_1byte``: ``fq(x) (M, K)
  bf16 @ W (K, N)`` with one code per byte (fp8 e4m3, fp6 e3m2 or e2m3, or
  int8), ``scale (K/32, N)``; ``act_fq`` in None, ``"float8_e4m3"``,
  ``"int8"``.
* B7 ``mx_matmul_fp4_pair`` (``csrc/mx_matmul.cu``, K3's kernel in its
  pair layout) replaces ``_linear_kernel_fp4``: the same with an fp4 weight
  in the reference's "pair" packing (``(K/2, N)`` bytes, byte p holding
  elements 2p (high nibble) and 2p + 1 (low nibble)); ``act_fq`` in None,
  ``"float8_e4m3"``, ``"int8"``.  At every M, K2 first writes x as its even
  and odd K planes (``cuda_quantize.mx_fake_quantize_planes``: fake-quantized,
  or copied where ``act_fq`` is None), as ``_pallas_matmul_fp4`` splits x
  before its kernel; its launch plan is :func:`plan_pair`.
* B8 ``mx_matmul_fp6q`` (``csrc/mx_matmul_fp6q.cu``) replaces
  ``_linear_kernel_fp6q``: the same with an fp6 weight in the planar
  quarters layout (``(3K/4, N)`` bytes, ``MXTensor.to_fp6_quarters``);
  ``act_fq`` in None, ``"float8_e4m3"``, applied by K2 first at every M (the
  kernel reads x as it is; :func:`act_fq_first`); its launch plan is
  :func:`plan_fp6q`.
* B9 ``mx_matmul_int8dot`` / ``mx_matmul_fp8dot`` (``csrc/mx_matmul_int8dot.cu``)
  replace ``_int8dot_kernel`` (and its ``fp8=True`` variant): x is quantized
  by K1 to int8 (or e4m3) codes and E8M0 scales, each 32-element block's dot
  with W's codes is taken on the codes (exact int32 for int8), multiplied by
  ``2^(sx-127)`` then ``2^(sw-127)`` (f32 factors built from the scale
  bytes: byte 0 gives +0) and added to an f32 accumulator in block order.
  On the card K1 writes x in B9's dot order (``cuda_quantize.mx_quantize_dot``:
  codes permuted inside each block as the kernel's W fragments come out,
  scales transposed as f32 factors), and the kernel runs B6's TMA + wgmma
  mainloop with one k32 wgmma on the raw codes per block and 64 rows; its
  launch plan is :func:`plan_int8dot`, with B6's splits.  Linears that read
  the same x (q/k/v, gate/up) share one K1 (``mx_quantize_dot``'s output,
  passed to each B9 call as ``xq``; ``layers/linear.shared_int8dot_x``).

Weight decode (B6, B8) is ``decode_codes_to_bf16(dot_operand=True)`` of the
reference, and ``decode_int8_to_bf16`` for int8: signed zeros and the fp8
NaN code are not reproduced, results below the bf16 normal range flush.

B6 forms each 32-block's partial product in a zeroed accumulator and adds
it to the row's sum in block order, over the same K splits as B9
(``cuda_matmul.k_splits``).  With int8 weights and an int8-grid x every
partial is exact, so B6 and B9 give a row the same bytes: the engine's rows
keep their bits whichever kernel their admission's size picks.  Above
``ACT_FQ_FUSE_MAX_M`` rows B6's wrapper fake-quantizes x once by K2 and
launches the kernel without ``act_fq`` (the same bytes as the fused
prologue); its launch plan is :func:`plan_1byte`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..mx_quantization import f32_from_bits
from ..packing import fp6_quarters_to_codes
from . import cuda_lib
from .backend import on_cuda
from .cuda_matmul import (SMEM_LIMIT, WgmmaPlan, check_matmul_operands, decode_code_dot, decode_fp4_to_bf16, fq_matmul,
                          k_splits, plan_halves, sm_count)
from .cuda_quantize import (PLANE_FORMATS, from_dot_order, mx_fake_quantize_planes, mx_quantize, mx_quantize_dot,
                            pair_width)
from .quantize import mx_fake_quantize

CODE_FORMATS_1BYTE = ("float8_e4m3", "float6_e3m2", "float6_e2m3", "int8")
FP6_FORMATS = ("float6_e3m2", "float6_e2m3")
ACT_FQ_1BYTE = (None, "float8_e4m3", "int8")
ACT_FQ_FP6Q = (None, "float8_e4m3")
INT8DOT_MAX_M = 256  # rows above which the JAX package leaves int8 dots for the 1-byte kernel
ACT_FQ_FP4_PAIR = PLANE_FORMATS  # B7's activation quantize is K2's plane mode
# Rows above which B6 takes x fake-quantized by K2 instead of fusing the
# activation quantize (``_ACT_FQ_FUSE_MAX_M`` of the reference).
ACT_FQ_FUSE_MAX_M = 64


def act_fq_first(layout: str, rows: int) -> bool:
    """Whether the kernel of a weight layout (``"1byte"``: B6, ``"pair"``:
    B7, ``"quarters"``: B8, ``"halves"``: K3) takes x already fake-quantized
    by K2 at ``rows`` rows, rather than fusing the activation quantize: B6
    above ``ACT_FQ_FUSE_MAX_M`` rows (as the reference's ``_run_kernel``),
    the others at every M (their kernels read x as it is; B7's in the plane
    order its own K2 writes).  Where it is true, the layers fake-quantize an
    x read by several linears of the row-major layouts once for all of them
    (``layers/linear.shared_activation_fq``)."""
    return rows > ACT_FQ_FUSE_MAX_M or layout in ("pair", "quarters", "halves")


def dequantize_1byte(w_codes: torch.Tensor, w_scale: torch.Tensor, elem_name: str) -> torch.Tensor:
    """(K, N) one-byte codes + (K/32, N) scales -> (K, N) bf16 weight."""
    codes = w_codes.to(torch.int32) if elem_name == "int8" else w_codes.to(torch.int32) & 0xFF
    return decode_code_dot(codes, w_scale.to(torch.int32).repeat_interleave(32, dim=0), elem_name)


def dequantize_fp6q(planes: torch.Tensor, w_scale: torch.Tensor, elem_name: str) -> torch.Tensor:
    return decode_code_dot(fp6_quarters_to_codes(planes),
                           w_scale.to(torch.int32).repeat_interleave(32, dim=0), elem_name)


def _check_formats(elem_name, act_fq, formats, acts, what):
    if elem_name not in formats:
        raise ValueError(f"the {what} kernel takes code formats {formats}, got {elem_name!r}")
    if act_fq not in acts:
        raise ValueError(f"the {what} kernel fuses act_fq in {acts}, got {act_fq!r}")


def mx_matmul_1byte_plain(x, w_codes, w_scale, elem_name: str, act_fq: Optional[str] = None):
    """Plain version of B6: fake-quantize x (if ``act_fq``), decode W, fp32
    matmul, one bf16 rounding."""
    return fq_matmul(x, dequantize_1byte(w_codes, w_scale, elem_name), act_fq)


# B6's launch (csrc/mx_matmul_1byte.cu): a CTA takes 128 columns of W (two
# warpgroups, one wgmma m64n128k16 each) and 128 rows of x, through a ring
# of 6 TMA stages of 64 K.
B6_BM = 128
B6_BN = 128
B6_STAGES = 6
# B8's (csrc/mx_matmul_fp6q.cu): the same tile through a ring of 3 stages of
# 128 K (one MX block of each K quarter).
B8_BM = 128
B8_BN = 128
B8_STAGES = 3


def b6_smem_bytes() -> int:
    """Smem::bytes of csrc/mx_matmul_1byte.cu: the x, code and scale rings,
    their mbarriers, the fp32 staging tile, 1024 bytes of slack."""
    ring = B6_STAGES * (B6_BM * 64 * 2 + 64 * B6_BN + 2 * B6_BN)
    return ring + 64 + B6_BM * (B6_BN + 8) * 4 + 1024


def plan_1byte(M: int, N: int, K: int, sms: int) -> WgmmaPlan:
    """B6's launch plan.  The tile, the instruction and the K order are the
    same at every M and the splits are ``k_splits(N, K)``: a row's bytes do
    not depend on M.  Where the output tiles alone make half a wave or more,
    each CTA sums its splits itself, in split order (the bytes of the
    two-pass form)."""
    splits = k_splits(N, K, sms)
    tiles = -(-M // B6_BM) * -(-N // B6_BN)
    return WgmmaPlan(B6_BM, B6_BN, B6_STAGES, b6_smem_bytes(), splits, splits > 1 and 2 * tiles >= sms)


def b6_kernel(x, w_codes, w_scale, elem_name: str, act_fq: Optional[str], plan: WgmmaPlan):
    """B6's main kernel alone on CUDA tensors the wrapper has checked:
    (out, None), or (out, the fp32 split partials) for :func:`b6_reduce`."""
    M, K = x.shape
    N = w_codes.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    two_pass = plan.splits > 1 and not plan.walk
    ws = torch.empty((plan.splits, M, N) if two_pass else (1,), dtype=torch.float32, device=x.device)
    act = -1 if act_fq is None else cuda_lib.ELEM_CODES[act_fq]
    cuda_lib.launch("mx_matmul_1byte", "mx_matmul_1byte_launch", x.data_ptr(), w_codes.data_ptr(),
                    w_scale.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N, K, cuda_lib.ELEM_CODES[elem_name],
                    act, plan.splits, int(plan.walk))
    return out, (ws if two_pass else None)


def b6_reduce(ws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """B6's second pass: ``out`` = the split partials summed in split order."""
    cuda_lib.launch("mx_matmul_1byte", "mx_matmul_1byte_reduce_launch", ws.data_ptr(), out.data_ptr(),
                    out.numel(), ws.shape[0], count=False)
    return out


def mx_matmul_1byte(x, w_codes, w_scale, elem_name: str, act_fq: Optional[str] = None):
    """B6: ``fq(x) @ W`` in bf16 for a one-byte-per-code weight.  CUDA
    tensors launch the kernel (K % 64 and N % 64 must be 0); the rest raises.
    Above ``ACT_FQ_FUSE_MAX_M`` rows x is fake-quantized once by K2 first."""
    _check_formats(elem_name, act_fq, CODE_FORMATS_1BYTE, ACT_FQ_1BYTE, "one-byte")
    if not on_cuda(x, w_codes, w_scale):
        return mx_matmul_1byte_plain(x, w_codes, w_scale, elem_name, act_fq)
    M, K = x.shape
    check_matmul_operands(x, w_codes, w_scale, K, torch.int8 if elem_name == "int8" else torch.uint8, "one-byte")
    if any(t.data_ptr() % 16 for t in (x, w_codes, w_scale)):
        raise ValueError("the one-byte kernel reads x, the codes and the scales 16 bytes at a time: "
                         "their storage must be 16-byte aligned")
    if act_fq is not None and act_fq_first("1byte", M):
        x, act_fq = mx_fake_quantize(x, act_fq), None
    out, ws = b6_kernel(x, w_codes, w_scale, elem_name, act_fq,
                        plan_1byte(M, w_codes.shape[1], K, sm_count(x.device)))
    return out if ws is None else b6_reduce(ws, out)


def mx_matmul_fp6q_plain(x, planes, w_scale, elem_name: str, act_fq: Optional[str] = None):
    """Plain version of B8."""
    return fq_matmul(x, dequantize_fp6q(planes, w_scale, elem_name), act_fq)


def b8_smem_bytes() -> int:
    """Smem::bytes of csrc/mx_matmul_fp6q.cu: the x (four 32-column slices),
    plane (three 32-row tiles) and scale (four rows) rings, their mbarriers,
    the fp32 staging tile, 1024 bytes of slack."""
    ring = B8_STAGES * (4 * B8_BM * 32 * 2 + 3 * 32 * B8_BN + 4 * B8_BN)
    return ring + 64 + B8_BM * (B8_BN + 8) * 4 + 1024


def plan_fp6q(M: int, N: int, K: int, sms: int) -> WgmmaPlan:
    """B8's launch plan: as :func:`plan_1byte`, with the splits
    ``k_splits(N, K, sms, 128)`` (128 K a stage).  The tile, the instruction
    and the K order are the same at every M: a row's bytes do not depend on
    M."""
    splits = k_splits(N, K, sms, 128)
    tiles = -(-M // B8_BM) * -(-N // B8_BN)
    return WgmmaPlan(B8_BM, B8_BN, B8_STAGES, b8_smem_bytes(), splits, splits > 1 and 2 * tiles >= sms)


def b8_kernel(x, planes, w_scale, elem_name: str, plan: WgmmaPlan):
    """B8's main kernel alone on CUDA tensors the wrapper has checked (x
    already fake-quantized where asked): (out, None), or (out, the fp32 split
    partials) for :func:`b8_reduce`."""
    M, K = x.shape
    N = planes.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    two_pass = plan.splits > 1 and not plan.walk
    ws = torch.empty((plan.splits, M, N) if two_pass else (1,), dtype=torch.float32, device=x.device)
    cuda_lib.launch("mx_matmul_fp6q", "mx_matmul_fp6q_launch", x.data_ptr(), planes.data_ptr(), w_scale.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), M, N, K, cuda_lib.ELEM_CODES[elem_name], plan.splits,
                    int(plan.walk))
    return out, (ws if two_pass else None)


def b8_reduce(ws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """B8's second pass: ``out`` = the split partials summed in split order."""
    cuda_lib.launch("mx_matmul_fp6q", "mx_matmul_fp6q_reduce_launch", ws.data_ptr(), out.data_ptr(),
                    out.numel(), ws.shape[0], count=False)
    return out


def mx_matmul_fp6q(x, planes, w_scale, elem_name: str, act_fq: Optional[str] = None):
    """B8: ``fq(x) @ W`` in bf16 for an fp6 weight in the quarters layout.
    CUDA tensors launch the kernel (K % 128 and N % 64 must be 0); the rest
    raises.  With ``act_fq`` x is fake-quantized once by K2 first, at every
    M: the kernel reads it as it is."""
    _check_formats(elem_name, act_fq, FP6_FORMATS, ACT_FQ_FP6Q, "fp6 quarters")
    if not on_cuda(x, planes, w_scale):
        return mx_matmul_fp6q_plain(x, planes, w_scale, elem_name, act_fq)
    M, K = x.shape
    check_matmul_operands(x, planes, w_scale, 3 * K // 4, torch.uint8, "fp6 quarters", k_multiple=128)
    if any(t.data_ptr() % 16 for t in (x, planes, w_scale)):
        raise ValueError("the fp6 quarters kernel reads x, the planes and the scales by TMA: "
                         "their storage must be 16-byte aligned")
    if act_fq is not None and act_fq_first("quarters", M):
        x = mx_fake_quantize(x, act_fq)
    out, ws = b8_kernel(x, planes, w_scale, elem_name, plan_fp6q(M, planes.shape[1], K, sm_count(x.device)))
    return out if ws is None else b8_reduce(ws, out)


def dequantize_fp4_pair(w_data: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """(K/2, N) pair bytes + (K/32, N) scales -> (K, N) bf16 weight, decoded
    as K3 decodes fp4 (``decode_fp4_to_bf16``)."""
    b = w_data.to(torch.int32)
    codes = torch.stack([b >> 4, b & 0xF], dim=1).reshape(2 * b.shape[0], b.shape[1])
    return decode_fp4_to_bf16(codes, w_scale.to(torch.int32).repeat_interleave(32, dim=0))


def fp4_pair_takes(K: int, N: int) -> bool:
    """The shapes JAX's plan serves with a pair fp4 weight (``_pick_tiles``:
    a K block of 256, 512 or 1024, or the whole K when 32 <= K <= 1024), with
    N a multiple of 64."""
    return (K % 256 == 0 or (32 <= K <= 1024 and K % 32 == 0)) and N % 64 == 0


def mx_matmul_fp4_pair_plain(x, w_data, w_scale, act_fq: Optional[str] = None):
    """Plain version of B7."""
    return fq_matmul(x, dequantize_fp4_pair(w_data, w_scale), act_fq)


def plan_pair(M: int, N: int, K: int, sms: int) -> WgmmaPlan:
    """B7's launch plan: K3's (:func:`plan_halves`, fp4) over the padded
    planes' width ``pair_width(K)``, so the splits are ``k_splits(N,
    pair_width(K), sms, 128)``; the tile, the instruction and the K order are
    the same at every M, so a row's bytes do not depend on M."""
    return plan_halves(M, N, pair_width(K), sms, "float4_e2m1")


def b7_kernel(xp, w_data, w_scale, K: int, plan: WgmmaPlan):
    """B7's main kernel alone on CUDA tensors the wrapper has checked, x in
    plane order ``xp (M, pair_width(K))``: (out, None), or (out, the fp32
    split partials) for :func:`b7_reduce`."""
    M, N = xp.shape[0], w_data.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xp.device)
    two_pass = plan.splits > 1 and not plan.walk
    ws = torch.empty((plan.splits, M, N) if two_pass else (1,), dtype=torch.float32, device=xp.device)
    cuda_lib.launch("mx_matmul", "mx_matmul_fp4_pair_launch", xp.data_ptr(), w_data.data_ptr(), w_scale.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), M, N, K, plan.splits, int(plan.walk))
    return out, (ws if two_pass else None)


def b7_reduce(ws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """B7's second pass: ``out`` = the split partials summed in split order."""
    cuda_lib.launch("mx_matmul", "mx_matmul_fp4_pair_reduce_launch", ws.data_ptr(), out.data_ptr(), out.numel(),
                    ws.shape[0], count=False)
    return out


def mx_matmul_fp4_pair(x, w_data, w_scale, act_fq: Optional[str] = None):
    """B7: ``fq(x) @ W`` in bf16 for an fp4 weight in the pair packing.  CUDA
    tensors run K2 in plane order (fake-quantizing with ``act_fq``, copying
    without), then the kernel, on the shapes ``fp4_pair_takes``; the rest
    raises."""
    if act_fq not in ACT_FQ_FP4_PAIR:
        raise ValueError(f"the fp4 pair kernel takes act_fq in {ACT_FQ_FP4_PAIR}, got {act_fq!r}")
    if not on_cuda(x, w_data, w_scale):
        return mx_matmul_fp4_pair_plain(x, w_data, w_scale, act_fq)
    M, K = x.shape
    N = w_data.shape[-1]
    if not fp4_pair_takes(K, N):
        raise ValueError(f"the fp4 pair kernel takes K % 256 == 0 or 32 <= K <= 1024 with K % 32 == 0, and "
                         f"N % 64 == 0, got K={K} N={N}")
    check_matmul_operands(x, w_data, w_scale, K // 2, torch.uint8, "fp4 pair", k_multiple=32)
    if any(t.data_ptr() % 16 for t in (w_data, w_scale)):
        raise ValueError("the fp4 pair kernel reads the weight and the scales by TMA: their storage must be "
                         "16-byte aligned")
    out, ws = b7_kernel(mx_fake_quantize_planes(x, act_fq), w_data, w_scale, K,
                        plan_pair(M, N, K, sm_count(x.device)))
    return out if ws is None else b7_reduce(ws, out)


def _code_values(codes: torch.Tensor, fp8: bool) -> torch.Tensor:
    """One-byte codes -> their exact values (int8, or e4m3 without scale) in float64."""
    if fp8:
        return codes.contiguous().view(torch.uint8).view(torch.float8_e4m3fn).float().double()
    return codes.view(torch.int8).to(torch.float64)


def mx_matmul_int8dot_plain(xc, sx, w_codes, w_scale, fp8: bool = False) -> torch.Tensor:
    """Plain version of B9 on codes: each 32-block's dot exact (float64),
    times ``2^(sx-127)`` then ``2^(sw-127)`` in f32, added in block order,
    one bf16 rounding."""
    M, K = xc.shape
    N, nb = w_codes.shape[1], K // 32
    xv = _code_values(xc, fp8).reshape(M, nb, 32).transpose(0, 1)
    wv = _code_values(w_codes, fp8).reshape(nb, 32, N)
    dots = torch.bmm(xv, wv).to(torch.float32)  # (nb, M, N)
    px = f32_from_bits(sx.to(torch.int32) << 23).t()  # (nb, M)
    pw = f32_from_bits(w_scale.to(torch.int32) << 23)  # (nb, N)
    acc = torch.zeros((M, N), dtype=torch.float32, device=xc.device)
    for b in range(nb):
        acc += (dots[b] * px[b][:, None]) * pw[b][None, :]
    return acc.to(torch.bfloat16)


# B9's launch (csrc/mx_matmul_int8dot.cu): a CTA takes 64 rows of x (one
# wgmma m64n64k32 per MX block) and 128 columns of W (two consumer
# warpgroups), through a ring of 8 TMA stages of 64 K.
B9_BM = 64
B9_BN = 128
B9_STAGES = 8


def b9_smem_bytes() -> int:
    """Smem::bytes of csrc/mx_matmul_int8dot.cu: the x code (64 x 64
    bytes), W code (64 x 128 bytes) and scale (W's two rows of 128 bytes,
    x's two rows of 64 f32 factors) rings, their full and empty mbarriers,
    the fp32 staging tile, 1024 bytes of slack."""
    ring = B9_STAGES * (B9_BM * 64 + 64 * B9_BN + 2 * B9_BN + 2 * B9_BM * 4)
    return ring + 16 * B9_STAGES + B9_BM * (B9_BN + 8) * 4 + 1024


@functools.lru_cache(maxsize=None)
def plan_int8dot(M: int, N: int, K: int, sms: int) -> WgmmaPlan:
    """B9's launch plan: B6's splits ``k_splits(N, K, sms)`` (64 K a stage),
    summed in split order, so that with exact int8 partials an int8 row gets
    B6's bytes; each CTA sums its splits itself where the output tiles make
    half a wave (the bytes of the two-pass form).  The tile (64 rows) and
    the instruction are the same at every M, so a row's bytes do not depend
    on M.  Cached: a decode step asks for the same few plans every call."""
    splits = k_splits(N, K, sms)
    tiles = -(-M // B9_BM) * -(-N // B9_BN)
    return WgmmaPlan(B9_BM, B9_BN, B9_STAGES, b9_smem_bytes(), splits, splits > 1 and 2 * tiles >= sms)


def _b9_fn(fp8: bool) -> str:
    return "mx_matmul_fp8dot" if fp8 else "mx_matmul_int8dot"


def b9_kernel(xd, px_t, w_codes, w_scale, fp8: bool, plan: WgmmaPlan, reduce: bool = False):
    """B9 on CUDA tensors the wrapper has checked, x as K1's dot-order mode
    writes it (``xd (M, K)``, ``px_t (K/32, Mp)``), in one host call:
    (out, None) where the product is whole after it (the plan walks its
    splits, or ``reduce`` has the same call launch the second pass), else
    the main kernel alone and (out, the fp32 split partials) for
    :func:`b9_reduce`."""
    M, K = xd.shape
    N = w_codes.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xd.device)
    ws = None if plan.walk or plan.splits == 1 else torch.empty((plan.splits, M, N), dtype=torch.float32,
                                                                 device=xd.device)
    cuda_lib.launch("mx_matmul_int8dot", _b9_fn(fp8) + "_launch", xd.data_ptr(), px_t.data_ptr(),
                    w_codes.data_ptr(), w_scale.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
                    M, N, K, px_t.shape[1], plan.splits, int(plan.walk), int(reduce))
    return out, (None if reduce else ws)


def b9_reduce(ws: torch.Tensor, out: torch.Tensor, fp8: bool) -> torch.Tensor:
    """B9's second pass: ``out`` = the split partials summed in split order."""
    cuda_lib.launch("mx_matmul_int8dot", _b9_fn(fp8) + "_reduce_launch", ws.data_ptr(), out.data_ptr(),
                    out.numel(), ws.shape[0], count=False)
    return out


def _check_int8dot(M: int, K: int, w_codes, w_scale, fp8: bool) -> None:
    """Raise unless the weight is what B9 takes at M rows of K: ``(K, N)``
    int8 (e4m3: uint8) codes and ``(K/32, N)`` uint8 scales, contiguous and
    16-byte aligned (TMA), with 0 < M <= ``INT8DOT_MAX_M``, K % 64 == 0 and
    N % 64 == 0."""
    N = w_codes.shape[-1]
    code_dtype = torch.uint8 if fp8 else torch.int8
    if w_codes.dtype != code_dtype or w_scale.dtype != torch.uint8:
        raise ValueError(f"B9 takes {code_dtype} codes and uint8 scales, got {w_codes.dtype} / {w_scale.dtype}")
    if not 0 < M <= INT8DOT_MAX_M or K % 64 or N % 64:
        raise ValueError(f"B9 needs 0 < M <= {INT8DOT_MAX_M}, K % 64 == 0 and N % 64 == 0, got M={M} K={K} N={N}")
    if w_codes.shape != (K, N) or w_scale.shape != (K // 32, N):
        raise ValueError(f"B9 weight shapes do not match K={K}: w {tuple(w_codes.shape)} sw {tuple(w_scale.shape)}")
    if not (w_codes.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("B9 operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (w_codes, w_scale)):
        raise ValueError("B9 reads the weight and its scales by TMA: their storage must be 16-byte aligned")


def mx_matmul_int8dot(x: torch.Tensor, w_codes, w_scale, fp8: bool = False, xq=None) -> torch.Tensor:
    """B9 on a bf16 x: K1 quantizes x to MXINT8 (MXFP8 with ``fp8``) codes
    and scales, as ``int8dot_any`` / ``fp8dot_any`` do, then the int8-dot
    kernel.  ``xq``: x as ``mx_quantize_dot`` already wrote it, shared
    by the linears that read the same x (x is then read for its shape only).
    CUDA tensors run K1's dot-order mode (unless ``xq``) and the kernel (the
    weight is checked first: nothing launches for a call that raises); CPU
    tensors the plain versions of both, ``xq``'s codes put back in natural
    order and its exponents read from the factors' bits."""
    fmt = "float8_e4m3" if fp8 else "int8"
    if not on_cuda(x, w_codes, w_scale):
        if xq is None:
            sx, xc = mx_quantize(x.contiguous(), fmt)
        else:
            px_t, xd = xq
            sx, xc = (px_t[:, :xd.shape[0]].t().contiguous().view(torch.int32) >> 23).to(torch.uint8), from_dot_order(xd)
        return mx_matmul_int8dot_plain(xc, sx, w_codes, w_scale, fp8)
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"B9 takes a 2-D bf16 x, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    _check_int8dot(M, K, w_codes, w_scale, fp8)
    px_t, xd = mx_quantize_dot(x.contiguous(), fmt) if xq is None else xq  # K1's own output: what the kernel takes
    plan = plan_int8dot(M, w_codes.shape[1], K, sm_count(x.device))
    return b9_kernel(xd, px_t, w_codes, w_scale, fp8, plan, reduce=True)[0]
