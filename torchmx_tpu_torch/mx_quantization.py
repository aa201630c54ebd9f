"""Bit-exact OCP MX quantization numerics in PyTorch.

Counterpart of ``torchmx_tpu/mx_quantization.py`` and held bit-exact against
it over every bf16 bit pattern (``tests/test_torch_numerics.py``).  Two
independent quantizers are bit-identical by contract:

* :func:`quantize_mx_with_e8m0_shared_exponent_hw_exact` — integer
  bit-manipulation on bf16 fields (normalise subnormals, rebase exponent,
  round-to-nearest-even with sticky bits, overflow carry, saturation,
  underflow last).  This is the specification the CUDA quantize kernel
  (``csrc/mx_quantize.cu``) implements.
* :func:`quantize_mx_with_e8m0_shared_exponent_simulated` — fp32 divide by
  the scale (as two fp32-normal factors), clamp, bit-level RNE cast.

All integer work is int32; bit patterns move between integer and float
tensors with ``Tensor.view`` (a bitcast).

Subnormals: the JAX reference runs under XLA, which flushes fp32 subnormal
arithmetic results to zero.  Where that flush is observable (the final
products of :func:`dequantize_mx`), this module flushes explicitly with
:func:`flush_subnormal`; everywhere else the recipes (integer
normalisation, two-factor scales) never produce a subnormal that matters.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import dtypes
from .packing import pack_uint4, unpack_uint4

F32_MIN_NORMAL = 2.0**-126


def n_ones(n: int) -> int:
    return (1 << n) - 1


def bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """bf16 tensor -> its 16-bit patterns as int32 in [0, 65535]."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an integer tensor -> bf16 tensor."""
    b = (bits.to(torch.int32) & 0xFFFF)
    return torch.where(b >= 0x8000, b - 0x10000, b).to(torch.int16).view(torch.bfloat16)


def f32_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an integer tensor (int32 or int64) -> fp32 tensor."""
    b = bits.to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Flush fp32 subnormals to a zero of the same sign (XLA's arithmetic
    semantics, which the reference package is written against)."""
    return torch.where(x.abs() < F32_MIN_NORMAL, x * 0.0, x)


def round_to_even(mantissa: torch.Tensor, mantissa_shift) -> torch.Tensor:
    """Drop ``mantissa_shift`` low bits with round-half-to-even; shifts are
    clamped to [1, 25] and a shift <= 0 keeps the mantissa."""
    mantissa = mantissa.to(torch.int32)
    shift_in = torch.as_tensor(mantissa_shift, dtype=torch.int32, device=mantissa.device)
    shift = shift_in.clamp(1, 25)
    one = torch.ones_like(shift)
    reduced = mantissa >> shift
    remainder = mantissa & ((one << shift) - 1)
    round_bit = remainder >> (shift - 1)
    odd = (reduced & 1) == 1
    sticky = (remainder & ((one << (shift - 1)) - 1)) != 0
    round_up = (round_bit > 0) & (odd | sticky)
    rounded = reduced + round_up.to(torch.int32)
    return torch.where(shift_in <= 0, mantissa, rounded)


def leading_one_position(mantissa: torch.Tensor, mantissa_size: int = 7) -> torch.Tensor:
    """Position of the leading 1 bit (LSB = 0); -1 if no bit is set."""
    mantissa = mantissa.to(torch.int32)
    pos = torch.full_like(mantissa, -1)
    for i in range(mantissa_size - 1, -1, -1):
        hit = ((mantissa & (1 << i)) != 0) & (pos == -1)
        pos = torch.where(hit, i, pos)
    return pos


def get_e8m0_shared_exponent(data_hp: torch.Tensor, elem_dtype: dtypes.DType) -> torch.Tensor:
    """Biased E8M0 exponent per block (block = last axis):
    ``clamp(max_biased_exp - max_pow2, 0, 254)``, 255 for blocks holding
    inf/NaN.  Returns uint8 with the last axis reduced."""
    if elem_dtype not in dtypes.SUPPORTED_ELEM_DTYPES:
        raise ValueError(f"unsupported element dtype {elem_dtype}")
    if data_hp.dtype == torch.bfloat16:
        exponent = (bf16_bits(data_hp) >> 7) & 0xFF
    elif data_hp.dtype == torch.float32:
        exponent = (data_hp.view(torch.int32) >> 23) & 0xFF
    else:
        raise TypeError(f"{data_hp.dtype} unsupported")
    max_exponent = exponent.amax(dim=-1)
    e8m0_max_biased = dtypes.e8m0.exponent_bias + dtypes.e8m0.max_pow2  # 254
    shared = (max_exponent - elem_dtype.max_pow2).clamp(0, e8m0_max_biased)
    shared = torch.where(
        max_exponent == dtypes.E8M0_EXPONENT_NAN_VAL, dtypes.E8M0_EXPONENT_NAN_VAL, shared
    )
    return shared.to(torch.uint8)


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact fp32 ``2**e`` for integer ``e`` in [-126, 127] (bit assembly)."""
    return f32_from_bits((e.to(torch.int64) + 127) << 23)


def pow2_split_factors(unbiased_exp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``2**unbiased_exp`` (exponent in [-252, 252]) into two
    fp32-normal factors, so no subnormal scale is ever materialised."""
    h1 = unbiased_exp >> 1  # floor division
    h2 = unbiased_exp - h1
    return _exp2i(h1), _exp2i(h2)


def bf16_to_f32_flush_safe(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 view of bf16 values with subnormal lanes pre-scaled by 2^64.

    Returns ``(values, prescale_exp)``; ``prescale_exp`` is 64 on the
    pre-scaled lanes and 0 elsewhere."""
    bits = bf16_bits(x)
    sign = (bits >> 15) & 1
    e = (bits >> 7) & 0xFF
    m = bits & 0x7F
    subnormal = (e == 0) & (m > 0)
    p = leading_one_position(m)
    norm_mant = (m << (7 - p).clamp(0, 8)) & 0x7F
    norm_exp = p - 133 + 64 + 127
    exp32 = torch.where(subnormal, norm_exp, e)
    mant32 = torch.where(subnormal, norm_mant, m) << 16
    values = f32_from_bits((sign.to(torch.int64) << 31) | (exp32.to(torch.int64) << 23) | mant32)
    prescale = torch.where(subnormal, 64, 0).to(torch.int32)
    return values, prescale


def quantize_mx_with_e8m0_shared_exponent_hw_exact(
    data_hp: torch.Tensor,
    elem_dtype: dtypes.DType,
    shared_exponent: torch.Tensor,
    orig_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Hardware-exact MX element cast on bf16 bit fields (see module doc).

    ``shared_exponent`` is uint8, broadcastable to ``data_hp``.  Returns the
    uint8 payload (fp4: two codes per byte, high nibble first)."""
    if data_hp.dtype != torch.bfloat16:
        raise TypeError("only bfloat16 input is supported")
    if elem_dtype not in dtypes.SUPPORTED_FP_ELEM_DTYPES:
        raise ValueError(f"unsupported element dtype {elem_dtype}")
    mb, eb = elem_dtype.mantissa_bits, elem_dtype.exponent_bits

    bits = bf16_bits(data_hp)
    sign = (bits >> 15) & 1
    exponent = (bits >> 7) & 0xFF
    mantissa = bits & 0x7F
    shared = shared_exponent.to(torch.int32).expand(data_hp.shape)
    nan_scale = shared == dtypes.E8M0_EXPONENT_NAN_VAL
    sign = torch.where(nan_scale, 0, sign)
    zeros_mask = (exponent == 0) & (mantissa == 0)

    # 1. normalise bf16 subnormal inputs
    subnormal_in = (exponent == 0) & ~zeros_mask
    leading_one = leading_one_position(mantissa)
    mantissa = torch.where(subnormal_in, (mantissa << (7 - leading_one).clamp(0, 8)) & 0x7F, mantissa)
    exponent = torch.where(subnormal_in, -(6 - leading_one), exponent)

    # 2. rebase the exponent onto the shared scale
    new_exponent = exponent - shared + elem_dtype.exponent_bias

    # 3. RNE: constant shift for normal outputs, per-element shift with a
    # sticky bit for subnormal outputs
    rounded = torch.where(new_exponent > 0, round_to_even(mantissa, 7 - mb), 0)
    output_subnormal = (new_exponent <= 0) & (new_exponent >= -mb) & ~zeros_mask
    sticky = ((mantissa & 0xF) != 0).to(torch.int32)
    subnormalized = (1 << 6) | ((mantissa >> 4) << 3) | (sticky << 2)
    rounded_sub = round_to_even(subnormalized, 7 - mb - new_exponent)
    rounded = torch.where(output_subnormal, rounded_sub, rounded)

    # 4. mantissa overflow carries into the exponent
    overflow = rounded > n_ones(mb)
    rounded = torch.where(overflow, 0, rounded)
    new_exponent = torch.where(overflow, new_exponent + 1, new_exponent)
    output_subnormal = (new_exponent <= 0) & (new_exponent >= -mb) & ~zeros_mask

    # 5. saturation; 6. underflow / zero / NaN-scale zeroing applied last
    underflow = (new_exponent < -mb) | nan_scale | zeros_mask
    saturation = new_exponent > n_ones(eb)
    max_normal = n_ones(mb + eb)
    if elem_dtype == dtypes.float8_e4m3:
        # S.1111.111 is NaN: 448 is S.1111.110
        saturation = saturation | ((new_exponent == 15) & (rounded == 7))
        max_normal = 0b1111_110
    normal = ~(saturation | underflow | output_subnormal)
    z = torch.where(output_subnormal, rounded, 0)
    z = torch.where(normal, (new_exponent.clamp(1, n_ones(eb)) << mb) | rounded, z)
    z = torch.where(saturation, max_normal, z)
    z = torch.where(underflow, 0, z)

    y = ((sign << (mb + eb)) | z).to(torch.uint8)
    if orig_shape is not None:
        y = y.reshape(orig_shape)
    if elem_dtype == dtypes.float4_e2m1:
        y = pack_uint4(y)
    return y


def f32_to_fpx_unpacked(x: torch.Tensor, elem_dtype: dtypes.DType) -> torch.Tensor:
    """RNE cast of finite, pre-clamped fp32 values to an (e, m) micro-float,
    one code per byte (IEEE narrowing at the bit level)."""
    mb, eb, bias = elem_dtype.mantissa_bits, elem_dtype.exponent_bits, elem_dtype.exponent_bias
    u32 = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = u32 & 0x7FFFFFFF
    sign = u32 >> 31
    exp_f32 = (bits >> 23) & 0xFF
    e_unbiased = exp_f32 - 127
    min_normal_exp = 1 - bias

    shift_n = 23 - mb
    rounded_field = (bits + ((bits >> shift_n) & 1) + ((1 << (shift_n - 1)) - 1)) >> shift_n
    exp_out = (rounded_field >> mb) - 127 + bias
    normal_code = (exp_out << mb) | (rounded_field & n_ones(mb))

    mant_ext = (1 << 23) | (bits & 0x7FFFFF)
    shift_s = ((23 - mb) + (min_normal_exp - e_unbiased)).clamp(1, 25)
    one = torch.ones_like(shift_s)
    q = (mant_ext + ((mant_ext >> shift_s) & 1) + ((one << shift_s) >> 1) - 1) >> shift_s

    code = torch.where(e_unbiased < min_normal_exp, q, normal_code)
    code = torch.where(exp_f32 == 0, 0, code)
    max_code = 0b1111_110 if elem_dtype == dtypes.float8_e4m3 else n_ones(mb + eb)
    code = code.clamp(0, max_code)
    return ((sign << (mb + eb)) | code).to(torch.uint8)


def quantize_mx_with_e8m0_shared_exponent_simulated(
    data_hp: torch.Tensor,
    elem_dtype: dtypes.DType,
    shared_exponent: torch.Tensor,
    orig_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Simulated MX quantization: fp32 divide by the scale (two fp32-normal
    factors), clamp to ``+/- max``, NaN lanes to +0, RNE element cast.
    Returns uint8 (int8 for the int8 format; fp4 nibble-packed)."""
    if elem_dtype not in dtypes.SUPPORTED_ELEM_DTYPES:
        raise ValueError(f"unsupported element dtype {elem_dtype}")
    if data_hp.dtype == torch.bfloat16:
        data_f32, prescale = bf16_to_f32_flush_safe(data_hp)
    else:
        data_f32 = data_hp.to(torch.float32)
        prescale = torch.zeros(data_f32.shape, dtype=torch.int32, device=data_f32.device)
    e = shared_exponent.to(torch.int32)
    inv1, inv2 = pow2_split_factors((127 - e) - prescale)
    inv1 = torch.where(e == dtypes.E8M0_EXPONENT_NAN_VAL, float("nan"), inv1)
    data_norm = (data_f32 * inv1) * inv2
    data_norm = data_norm.clamp(-elem_dtype.max, elem_dtype.max)
    data_norm = torch.where(torch.isnan(data_norm), 0.0, data_norm)
    if orig_shape is not None:
        data_norm = data_norm.reshape(orig_shape)
    if elem_dtype == dtypes.int8:
        return torch.round(data_norm).to(torch.int8)  # half-to-even
    data_lp = f32_to_fpx_unpacked(data_norm, elem_dtype)
    if elem_dtype == dtypes.float4_e2m1:
        data_lp = pack_uint4(data_lp)
    return data_lp


def dequantize_to_dtype(
    data_lp: torch.Tensor,
    elem_dtype: dtypes.DType,
    target_dtype: torch.dtype,
    packing_dim: int = -1,
    is_packed_fp4: bool = True,
) -> torch.Tensor:
    """Decode fp8/6/4 codes (uint8) exactly; e4m3's S.1111.111 is NaN."""
    if elem_dtype not in dtypes.SUPPORTED_FP_ELEM_DTYPES:
        raise ValueError(f"unsupported element dtype {elem_dtype}")
    if data_lp.dtype != torch.uint8:
        raise TypeError("codes must be uint8")
    if is_packed_fp4 and elem_dtype == dtypes.float4_e2m1:
        data_lp = unpack_uint4(data_lp, packing_dim)
    mb, eb = elem_dtype.mantissa_bits, elem_dtype.exponent_bits
    code = data_lp.to(torch.int32)
    exp_field = (code >> mb) & n_ones(eb)
    mantissa = code & n_ones(mb)
    sign = code >> (mb + eb)
    frac = mantissa.to(torch.float32) / (2**mb)
    frac = torch.where(exp_field == 0, frac, 1 + frac)
    exponent = torch.where(exp_field == 0, 1, exp_field) - elem_dtype.exponent_bias
    # every fp8/6/4 value is exact in fp32 (and bf16)
    y = (1 - 2 * sign).to(torch.float32) * _exp2i(exponent) * frac
    if elem_dtype == dtypes.float8_e4m3:
        y = torch.where((exp_field == 15) & (mantissa == 7), float("nan"), y)
    return y.to(target_dtype)
