"""K3 ``mx_matmul_fp4_halves``: the CUDA kernel (``csrc/mx_matmul.cu``) and
its plain PyTorch version.

Replaces ``torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp4_halves``:
``x (M, K) bf16 @ W (K, N)`` with W MXFP4 in the K-major halves layout
(``W (K/2, N) uint8``, byte p holds elements p and p + K/2; ``scale
(K/32, N) uint8``), fp32 accumulation, one bf16 rounding, and an optional
fused activation fake-quantize (``act_fq``) of each 32-element x block.

Weight decode follows ``decode_fp4_to_bf16`` of the reference: the scale
folds into the bf16 exponent, and results below the bf16 normal range flush
to zero (the plain version flushes explicitly).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mx_quantization import bf16_from_bits
from . import cuda_lib
from .backend import on_cuda
from .cuda_quantize import mx_fake_quantize_plain

ACT_FQ_FORMATS = (None, "float8_e4m3")  # activation formats K3 fuses


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


def mx_matmul_fp4_halves_plain(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act_fq: Optional[str] = None
) -> torch.Tensor:
    """Plain version of K3: fake-quantize x (if ``act_fq``), decode W, fp32
    matmul, one bf16 rounding."""
    if act_fq is not None:
        x = mx_fake_quantize_plain(x, act_fq)
    w = dequantize_fp4_halves(w_data, w_scale)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(torch.bfloat16)


def _plan(M: int, N: int, K: int, device: torch.device):
    """(rows per tile, K splits) for the kernel.  The tile follows M.  The
    splits follow N and K alone: enough that a single row tile (decode) keeps
    the SMs busy.  An output element's fp32 sum order is fixed by the splits,
    so a row's result does not depend on how many other rows share the call:
    a prompt admitted whole, in chunks or after a cached prefix gets the same
    bytes.  (At large M the extra splits cost a pass over the fp32 partials.)"""
    bm = 16 if M <= 16 else (64 if M <= 64 or N % 128 else 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(K // 64, 16, -(-2 * sms // (N // 64))))
    return bm, splits


def mx_matmul_fp4_halves(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act_fq: Optional[str] = None
) -> torch.Tensor:
    """K3: ``(fq(x) @ W)`` in bf16.  CUDA tensors launch the kernel; shapes
    it does not take raise.  ``act_fq`` is None or ``"float8_e4m3"``."""
    if act_fq not in ACT_FQ_FORMATS:
        raise ValueError(f"the fp4 matmul fuses act_fq in {ACT_FQ_FORMATS}, got {act_fq!r}")
    if not on_cuda(x, w_data, w_scale):
        return mx_matmul_fp4_halves_plain(x, w_data, w_scale, act_fq)
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = w_data.shape[1]
    if K % 64 or N % 64:
        raise ValueError(f"the fp4 matmul kernel needs K % 64 == 0 and N % 64 == 0, got K={K} N={N}")
    if w_data.shape != (K // 2, N) or w_scale.shape != (K // 32, N):
        raise ValueError(f"weight {tuple(w_data.shape)} / scale {tuple(w_scale.shape)} do not match K={K}")
    if w_data.dtype != torch.uint8 or w_scale.dtype != torch.uint8:
        raise ValueError("weight payload and scale must be uint8")
    if not (w_data.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("weight payload and scale must be contiguous")
    bm, splits = _plan(M, N, K, x.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((splits, M, N) if splits > 1 else (1,), dtype=torch.float32, device=x.device)
    act = -1 if act_fq is None else cuda_lib.ELEM_CODES[act_fq]
    cuda_lib.launch(
        "mx_matmul", "mx_matmul_fp4_halves_launch",
        x.data_ptr(), w_data.data_ptr(), w_scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
        M, N, K, act, bm, splits,
    )
    return out
