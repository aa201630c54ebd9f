"""K3 ``mx_matmul_fp4_halves`` and its fp8 variant ``mx_matmul_fp8_halves``:
the CUDA kernel (``csrc/mx_matmul.cu``), its launch plan and its plain
PyTorch versions.

Replaces ``torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp4_halves``:
``fq(x) (M, K) bf16 @ W (K, N)`` with W in a K-major halves layout, fp32
accumulation and one bf16 rounding.  The weight is MXFP4 (``W (K/2, N)
uint8``, byte p holds elements p and p + K/2) or MXFP8 (``W (K/2, N)
uint16``, word p holds the codes of elements p and p + K/2: the JAX kernel's
``elem_name="float8_e4m3"``); ``scale (K/32, N) uint8``.  The activation
quantize (``act_fq``) is applied by K2 first, at every M: the kernel reads x
as it is, and the layers share that K2 among the linears reading one x
(``cuda_matmul_formats.act_fq_first``).  The kernel runs B8's TMA + wgmma
mainloop (:func:`plan_halves`).

Weight decode follows ``decode_fp4_to_bf16`` of the reference for fp4 (the
scale folds into the bf16 exponent, results below the bf16 normal range
flush to zero; the plain version flushes explicitly) and
``decode_codes_to_bf16(dot_operand=True)`` for fp8
(:func:`decode_code_dot`, which B6 and B8 share).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import dtypes
from ..mx_quantization import bf16_from_bits, f32_from_bits
from ..packing import fp8_halves_to_codes
from . import cuda_lib
from .backend import on_cuda
from .cuda_quantize import mx_fake_quantize_plain
from .quantize import mx_fake_quantize

ACT_FQ_FORMATS = (None, "float8_e4m3")  # activation formats K3's wrappers take


def decode_fp4_to_bf16(nibbles: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """fp4 codes (int32, one nibble each) times ``2^(se-127)`` -> bf16, with
    sub-bf16-normal results flushed to a signed zero."""
    c = nibbles & 7
    bits = 0x3EC0 + (c << 6) + ((c >= 2).to(torch.int32) << 6) + ((se - 127) << 7)
    dead = (c == 0) | (bits < 0x80)
    bits = torch.where(dead, 0, bits) | ((nibbles & 8) << 12)
    return bf16_from_bits(bits)


def dequantize_fp4_halves(w_data: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """(K/2, N) halves bytes + (K/32, N) scales -> (K, N) bf16 weight."""
    b = w_data.to(torch.int32)
    codes = torch.cat([b >> 4, b & 0xF], dim=0)
    se = w_scale.to(torch.int32).repeat_interleave(32, dim=0)
    return decode_fp4_to_bf16(codes, se)


def fq_matmul(x: torch.Tensor, w: torch.Tensor, act_fq: Optional[str]) -> torch.Tensor:
    """The matmul kernels' plain versions: fake-quantize x (if ``act_fq``),
    fp32 matmul with the decoded bf16 W, one bf16 rounding."""
    if act_fq is not None:
        x = mx_fake_quantize_plain(x, act_fq)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(torch.bfloat16)


def mx_matmul_fp4_halves_plain(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act_fq: Optional[str] = None
) -> torch.Tensor:
    """Plain version of K3."""
    return fq_matmul(x, dequantize_fp4_halves(w_data, w_scale), act_fq)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k_splits(N: int, K: int, sms: int, k_tile: int = 64) -> int:
    """The K splits of the matmul kernels: enough that one row tile of 64
    columns makes two CTAs an SM, at most 16 and at most one per K step.
    An output element's fp32 sum order is fixed by the splits, so a row's
    result does not depend on how many other rows share the call: a prompt
    admitted whole, in chunks or after a cached prefix gets the same bytes.
    B6, B9 and B12 take the same splits, which is what lets B9 and B12 give
    an int8 row B6's bytes."""
    return max(1, min(K // k_tile, 16, -(-2 * sms // (N // 64))))


def decode_code_dot(codes: torch.Tensor, se: torch.Tensor, elem_name: str) -> torch.Tensor:
    """int32 codes times ``2^(se-127)`` -> bf16, as a dot operand
    (``mx_common.cuh::decode_code_dot``): the exponent and mantissa bits land
    in the bf16 fields, the scale folds into the exponent, a subnormal code
    decodes as ``(1 + m/2^mb) 2^F - 2^F``; results below the bf16 normal range
    flush to zero; int8 is ``code * 2^(se-127)``."""
    se = se.to(torch.int32)
    if elem_name == "int8":
        v = codes.to(torch.int8).to(torch.float32) * f32_from_bits(se << 23)
        return v.to(torch.bfloat16)
    elem = dtypes.STR_TO_SUPPORTED_ELEM_DTYPE[elem_name]
    mb, nbits = elem.mantissa_bits, elem.mantissa_bits + elem.exponent_bits
    codes = codes.to(torch.int32)
    mag = (codes & ((1 << nbits) - 1)) << (7 - mb)
    sub = (mag < 0x80).to(torch.int32)
    fshift = (se - elem.exponent_bias + sub) << 7
    b = mag + fshift
    dead = b < 0x80
    f = torch.where(dead, 0.0, f32_from_bits(b << 16))
    c = torch.where((sub == 1) & ~dead, f32_from_bits(fshift << 16), 0.0)
    v = f - c
    return torch.where(((codes >> nbits) & 1) == 1, -v, v).to(torch.bfloat16)


def dequantize_fp8_halves(w_data: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """(K/2, N) uint16 halves words + (K/32, N) scales -> (K, N) bf16 weight."""
    se = w_scale.to(torch.int32).repeat_interleave(32, dim=0)
    return decode_code_dot(fp8_halves_to_codes(w_data), se, "float8_e4m3")


def mx_matmul_fp8_halves_plain(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act_fq: Optional[str] = None
) -> torch.Tensor:
    """Plain version of K3 over an fp8 halves weight."""
    return fq_matmul(x, dequantize_fp8_halves(w_data, w_scale), act_fq)


def check_matmul_operands(x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor,
                          w_rows: int, w_dtype: torch.dtype, what: str, k_multiple: int = 64):
    """Raise unless x is a contiguous 2-D bf16 (M, K) with K and N
    multiples of the kernels' tiles and the weight ``(w_rows, N)`` of
    ``w_dtype`` with a ``(K/32, N)`` uint8 scale, both contiguous."""
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    K, N = x.shape[1], w_data.shape[-1]
    if K % k_multiple or N % 64:
        raise ValueError(f"the {what} kernel needs K % {k_multiple} == 0 and N % 64 == 0, got K={K} N={N}")
    if w_data.shape != (w_rows, N) or w_scale.shape != (K // 32, N):
        raise ValueError(f"weight {tuple(w_data.shape)} / scale {tuple(w_scale.shape)} do not match K={K}")
    if w_data.dtype != w_dtype or w_scale.dtype != torch.uint8:
        raise ValueError(f"the {what} kernel takes a {w_dtype} payload and a uint8 scale, "
                         f"got {w_data.dtype} / {w_scale.dtype}")
    if not (w_data.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("weight payload and scale must be contiguous")


SMEM_LIMIT = 232_448  # dynamic shared memory a block can use on an H100


class WgmmaPlan(NamedTuple):
    """The launch plan of a TMA + wgmma matmul kernel (B6, B8, K3)."""

    bm: int  # rows of x a CTA
    bn: int  # columns of W a CTA
    stages: int
    smem_bytes: int  # the kernel's dynamic shared memory (Smem::bytes)
    splits: int  # K splits: k_splits(N, K)
    walk: bool  # each CTA walks its splits (no fp32 workspace, no second pass)


# K3's launch (csrc/mx_matmul.cu): a CTA takes 128 columns of W (two
# warpgroups, one wgmma m64n128k16 each) and 128 rows of x, through a ring
# of 3 TMA stages of 128 K (64 packed rows, 64 K of each half).
K3_BM = 128
K3_BN = 128
K3_STAGES = 3
HALVES_FORMATS = {"float4_e2m1": torch.uint8, "float8_e4m3": torch.uint16}  # K3's weight formats and payloads


def k3_smem_bytes(elem_name: str) -> int:
    """Smem::bytes of csrc/mx_matmul.cu: the x (two 64-column slices), W (64
    packed rows: one byte a column for fp4, one word for fp8) and scale (four
    rows) rings, their mbarriers, the fp32 staging tile, 1024 bytes of
    slack."""
    w_bytes = 64 * K3_BN * HALVES_FORMATS[elem_name].itemsize
    ring = K3_STAGES * (2 * K3_BM * 64 * 2 + w_bytes + 4 * K3_BN)
    return ring + 64 + K3_BM * (K3_BN + 8) * 4 + 1024


def plan_halves(M: int, N: int, K: int, sms: int, elem_name: str = "float4_e2m1") -> WgmmaPlan:
    """K3's launch plan: the splits ``k_splits(N, K, sms, 128)`` (128 K a
    stage); the tile, the instruction and the K order are the same at every
    M, so a row's bytes do not depend on M.  Where the output tiles alone
    make half a wave or more, each CTA sums its splits itself, in split
    order (the bytes of the two-pass form)."""
    splits = k_splits(N, K, sms, 128)
    tiles = -(-M // K3_BM) * -(-N // K3_BN)
    return WgmmaPlan(K3_BM, K3_BN, K3_STAGES, k3_smem_bytes(elem_name), splits, splits > 1 and 2 * tiles >= sms)


def _halves_fn(elem_name: str) -> str:
    return "mx_matmul_fp4_halves" if elem_name == "float4_e2m1" else "mx_matmul_fp8_halves"


def k3_kernel(x, w_data, w_scale, elem_name: str, plan: WgmmaPlan):
    """K3's main kernel alone on CUDA tensors the wrapper has checked (x
    already fake-quantized where asked): (out, None), or (out, the fp32 split
    partials) for :func:`k3_reduce`."""
    M, K = x.shape
    N = w_data.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    two_pass = plan.splits > 1 and not plan.walk
    ws = torch.empty((plan.splits, M, N) if two_pass else (1,), dtype=torch.float32, device=x.device)
    cuda_lib.launch("mx_matmul", _halves_fn(elem_name) + "_launch", x.data_ptr(), w_data.data_ptr(),
                    w_scale.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N, K, plan.splits, int(plan.walk))
    return out, (ws if two_pass else None)


def k3_reduce(ws: torch.Tensor, out: torch.Tensor, elem_name: str) -> torch.Tensor:
    """K3's second pass: ``out`` = the split partials summed in split order."""
    cuda_lib.launch("mx_matmul", _halves_fn(elem_name) + "_reduce_launch", ws.data_ptr(), out.data_ptr(),
                    out.numel(), ws.shape[0], count=False)
    return out


def _halves(x, w_data, w_scale, act_fq, elem_name):
    what = "fp4 halves" if elem_name == "float4_e2m1" else "fp8 halves"
    if act_fq not in ACT_FQ_FORMATS:
        raise ValueError(f"the {what} matmul takes act_fq in {ACT_FQ_FORMATS}, got {act_fq!r}")
    if not on_cuda(x, w_data, w_scale):
        plain = mx_matmul_fp4_halves_plain if elem_name == "float4_e2m1" else mx_matmul_fp8_halves_plain
        return plain(x, w_data, w_scale, act_fq)
    M, K = x.shape
    check_matmul_operands(x, w_data, w_scale, K // 2, HALVES_FORMATS[elem_name], what, k_multiple=128)
    if any(t.data_ptr() % 16 for t in (x, w_data, w_scale)):
        raise ValueError(f"the {what} kernel reads x, the weight and the scales by TMA: "
                         "their storage must be 16-byte aligned")
    if act_fq is not None:
        x = mx_fake_quantize(x, act_fq)
    out, ws = k3_kernel(x, w_data, w_scale, elem_name, plan_halves(M, w_data.shape[1], K, sm_count(x.device),
                                                                   elem_name))
    return out if ws is None else k3_reduce(ws, out, elem_name)


def mx_matmul_fp4_halves(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act_fq: Optional[str] = None
) -> torch.Tensor:
    """K3: ``(fq(x) @ W)`` in bf16.  CUDA tensors launch the kernel (K % 128
    and N % 64 must be 0); shapes it does not take raise.  ``act_fq`` is
    None or ``"float8_e4m3"``, applied by K2 first."""
    return _halves(x, w_data, w_scale, act_fq, "float4_e2m1")


def mx_matmul_fp8_halves(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act_fq: Optional[str] = None
) -> torch.Tensor:
    """K3 over an fp8 halves weight (uint16 words), counted as
    ``mx_matmul_fp8_halves``.  ``act_fq`` is None or ``"float8_e4m3"``."""
    return _halves(x, w_data, w_scale, act_fq, "float8_e4m3")
