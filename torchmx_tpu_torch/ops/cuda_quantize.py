"""K1 ``mx_quantize`` and K2 ``mx_fake_quantize``: CUDA kernels
(``csrc/mx_quantize.cu``) and their plain PyTorch versions.

They replace ``torchmx_tpu/ops/pallas_quantize.py``'s ``_quantize_kernel``
(bf16 -> E8M0 scale + hw-exact RNE codes) and ``_fake_quantize_kernel`` /
``_fake_quantize_lane_kernel`` (quantize-dequantize in one pass with the fp32
magic-number RNE).  Both kernels are bit-exact to their plain versions over
every bf16 bit pattern (checked on the card by ``chip_smoke.py``).

Fake-quantize contract: ``mx_fake_quantize(x) == dequantize_mx(quantize_mx(x))``
bit for bit, including the flush of results below the fp32 normal range to a
signed zero that ``dequantize_mx`` inherits from the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import dtypes
from ..mx_array import quantize_mx_plain
from ..mx_quantization import (
    F32_MIN_NORMAL,
    bf16_bits,
    f32_from_bits,
    get_e8m0_shared_exponent,
    leading_one_position,
)
from . import cuda_lib
from .backend import on_cuda

BLOCK = 32


def _check_kernel_input(x: torch.Tensor, block_size: int) -> torch.Tensor:
    if block_size != BLOCK:
        raise ValueError(f"the CUDA kernels take block_size {BLOCK}, got {block_size}")
    if x.dtype != torch.bfloat16 or x.shape[-1] % BLOCK:
        raise ValueError(f"need bf16 with a last dim multiple of {BLOCK}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the quantize kernels need a contiguous input")
    return x


def mx_quantize_plain(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (scale (..., K/bs) uint8, codes (..., K) uint8,
    int8 for int8, fp4 pair-packed (..., K/2))."""
    return quantize_mx_plain(x, elem_dtype_name, block_size)


def mx_quantize(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: quantize along the last dim.  CUDA tensors launch the kernel."""
    if not on_cuda(x):
        return mx_quantize_plain(x, elem_dtype_name, block_size)
    _check_kernel_input(x, block_size)
    K = x.shape[-1]
    lead = tuple(x.shape[:-1])
    scale = torch.empty(lead + (K // BLOCK,), dtype=torch.uint8, device=x.device)
    width = K // 2 if elem_dtype_name == "float4_e2m1" else K
    cdt = torch.int8 if elem_dtype_name == "int8" else torch.uint8
    codes = torch.empty(lead + (width,), dtype=cdt, device=x.device)
    cuda_lib.launch(
        "mx_quantize", "mx_quantize_launch",
        x.data_ptr(), scale.data_ptr(), codes.data_ptr(),
        x.numel() // K, K, cuda_lib.ELEM_CODES[elem_dtype_name],
    )
    return scale, codes


def mx_fake_quantize_plain(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> torch.Tensor:
    """Plain version of K2 (``_fq_magic_cast`` of the reference): clamp to
    ``max * 2^(se-127)``, round to the MX quantum ``2^qe`` by
    ``(|x| + M) - M`` in fp32, re-apply the sign, flush results below the
    fp32 normal range, NaN for NaN-scale blocks."""
    elem = dtypes.STR_TO_SUPPORTED_ELEM_DTYPE[elem_dtype_name]
    shape = x.shape
    xb = x.reshape(-1, block_size)
    bits = bf16_bits(xb)
    se = get_e8m0_shared_exponent(xb, elem).to(torch.int32)[:, None]

    tmant = int(round((elem.max / 2.0**elem.max_pow2 - 1.0) * 2**23))
    t_field = se + elem.max_pow2
    t = f32_from_bits(torch.where(t_field >= 255, 0x7F800000, (t_field << 23) | tmant))
    a = torch.minimum(xb.to(torch.float32).abs(), t)
    if elem == dtypes.int8:
        qe = (se - 127).expand(bits.shape)
    else:
        mb = elem.mantissa_bits
        e_x = (bits >> 7) & 0xFF
        man = bits & 0x7F
        e_eff = torch.where((e_x == 0) & (man != 0), leading_one_position(man) - 6, e_x)
        qe = torch.maximum(e_eff - 127 - mb, se + (1 - elem.exponent_bias - mb - 127))
    big = qe > 100  # keep the magic constant fp32-normal
    mg = f32_from_bits(((qe - torch.where(big, 64, 0) + 150) << 23) | 0x400000)
    a = torch.where(big, a * 2.0**-64, a)
    r = (a + mg) - mg
    r = torch.where(big, r * 2.0**64, r)
    sgn = (bits.to(torch.int64) & 0x8000) << 16
    if elem == dtypes.int8:
        sgn = torch.where(r == 0, 0, sgn)  # int8 has no signed zero
    r = torch.where(r < F32_MIN_NORMAL, 0.0, r)
    y = f32_from_bits(r.view(torch.int32).to(torch.int64) | sgn).to(torch.bfloat16)
    y = torch.where(se == 255, float("nan"), y)
    return y.reshape(shape)


def mx_fake_quantize_kernel(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> torch.Tensor:
    """K2 on a CUDA tensor: one pass, bf16 in and out."""
    _check_kernel_input(x, block_size)
    out = torch.empty_like(x)
    K = x.shape[-1]
    cuda_lib.launch(
        "mx_quantize", "mx_fake_quantize_launch",
        x.data_ptr(), out.data_ptr(), x.numel() // K, K, cuda_lib.ELEM_CODES[elem_dtype_name],
    )
    return out
