"""``MXTensor``, the MX-quantized tensor (counterpart of ``MXArray`` in
``torchmx_tpu/mx_array.py``), and the op-level seam ``quantize_mx`` /
``dequantize_mx``.

Fields of :class:`MXTensor`:

* ``scale_e8m0`` — uint8, the payload shape with ``block_dim`` divided by
  ``block_size``;
* ``data`` — uint8 payload (int8 for the int8 format; fp4 packs two codes
  per byte along ``block_dim``);
* metadata: ``elem_dtype``, ``block_size``, ``orig_dtype``, ``block_dim``,
  ``padding``, ``fp4_pack``, the payload layout (the JAX package's field
  name, which covers the 2-D K-major kernel layouts of every format):

  - ``"pair"``: the reference layout, one code per byte (fp4: neighbours
    (2p, 2p+1) share a byte, high nibble first);
  - ``"halves"``: fp4 bytes ``(K/2, N)`` where byte p holds elements p (high
    nibble) and p + K/2 (low), or fp8 ``uint16`` words ``(K/2, N)`` where word
    p holds the codes of elements p (high byte) and p + K/2 (low): K3's
    layouts;
  - ``"quarters"``: fp6 in three byte planes of ``K/4`` rows, 4 codes per 3
    bytes (``P0 = q0 << 2 | q3 >> 4``, ``P1 = q1 << 2 | (q3 >> 2) & 3``,
    ``P2 = q2 << 2 | q3 & 3`` for the codes q0..q3 of the four K quarters):
    B8's layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import dtypes
from . import env_variables as env
from .mx_quantization import (
    dequantize_to_dtype,
    flush_subnormal,
    get_e8m0_shared_exponent,
    pow2_split_factors,
    quantize_mx_with_e8m0_shared_exponent_hw_exact,
    quantize_mx_with_e8m0_shared_exponent_simulated,
)
from .packing import fp6_quarters_to_codes, fp8_halves_to_codes, pack_uint4, unpack_uint4


def quantize_mx_plain(
    data_hp: torch.Tensor, elem_dtype_name: str, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch quantizer: returns ``(scale (..., D/bs) uint8, payload)``.
    ``MX_HARDWARE_EXACT_QUANTIZATION`` picks the implementation (fp formats
    only); both are bit-identical."""
    elem = dtypes.STR_TO_SUPPORTED_ELEM_DTYPE[elem_dtype_name]
    orig_shape = data_hp.shape
    blocked = data_hp.reshape(-1, block_size)
    se = get_e8m0_shared_exponent(blocked, elem)
    if elem in dtypes.SUPPORTED_FP_ELEM_DTYPES and env.MX_EXACT_QUANTIZATION == "True":
        quantize = quantize_mx_with_e8m0_shared_exponent_hw_exact
    else:
        quantize = quantize_mx_with_e8m0_shared_exponent_simulated
    data_lp = quantize(blocked, elem, se[:, None], orig_shape)
    return se.reshape(*orig_shape[:-1], -1), data_lp


def quantize_mx(
    data_hp: torch.Tensor, elem_dtype_name: str, block_size: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last dim into (E8M0 scale, payload).

    Input ``(..., D)`` bf16 with ``D % block_size == 0``; returns the scale
    ``(..., D // block_size)`` uint8 and the payload ``(..., D)`` (fp4:
    ``(..., D // 2)`` packed).  A CUDA tensor goes through the quantize
    kernel (block size 32 only); a CPU tensor through the plain version."""
    if data_hp.dtype != torch.bfloat16:
        raise TypeError(f"only bfloat16 input is supported, got {data_hp.dtype}")
    if data_hp.shape[-1] % block_size:
        raise ValueError("the last dimension must be a multiple of block_size")
    from .ops.cuda_quantize import mx_quantize

    return mx_quantize(data_hp, elem_dtype_name, block_size)


def dequantize_mx(
    data_lp: torch.Tensor,
    shared_exp_e8m0: torch.Tensor,
    elem_dtype_name: str,
    block_size: int,
    target_dtype: torch.dtype,
    block_dim: int,
) -> torch.Tensor:
    """Decode payload + scale to ``target_dtype``: exact element decode, then
    the power-of-two scale as two fp32-normal factors (NaN for 255), with
    results below the fp32 normal range flushed to a signed zero as XLA
    does, and one final rounding."""
    elem = dtypes.STR_TO_SUPPORTED_ELEM_DTYPE[elem_dtype_name]
    if elem in dtypes.SUPPORTED_FP_ELEM_DTYPES:
        data_hp = dequantize_to_dtype(data_lp, elem, torch.float32, block_dim)
    else:
        data_hp = data_lp.to(torch.float32)
    e = shared_exp_e8m0.to(torch.int32)
    s1, s2 = pow2_split_factors(e - 127)
    s1 = torch.where(e == dtypes.E8M0_EXPONENT_NAN_VAL, float("nan"), s1)
    s1 = s1.repeat_interleave(block_size, dim=block_dim)
    s2 = s2.repeat_interleave(block_size, dim=block_dim)
    return flush_subnormal((data_hp * s1) * s2).to(target_dtype)


class MXTensor:
    """MX block-floating-point tensor: packed payload + per-block E8M0 scale."""

    def __init__(
        self,
        scale_e8m0: torch.Tensor,
        data: torch.Tensor,
        elem_dtype,
        block_size: int,
        orig_dtype: torch.dtype = torch.bfloat16,
        padding: int = 0,
        block_dim: Optional[int] = None,
        fp4_pack: str = "pair",
    ):
        elem_dtype = dtypes.as_dtype(elem_dtype)
        if scale_e8m0.dtype != torch.uint8:
            raise TypeError("scale must be uint8")
        if data.dtype not in (torch.uint8, torch.int8, torch.uint16):
            raise TypeError(f"{data.dtype} payload is unsupported")
        if fp4_pack not in ("pair", "halves", "quarters"):
            raise ValueError(fp4_pack)
        self.scale_e8m0 = scale_e8m0
        self.data = data
        self.elem_dtype = elem_dtype
        self.block_size = block_size
        self.orig_dtype = orig_dtype
        self.block_dim = data.dim() - 1 if block_dim is None else block_dim % data.dim()
        self.padding = padding
        self.fp4_pack = fp4_pack
        expected = list(scale_e8m0.shape)
        expected[self.block_dim] = expected[self.block_dim] * block_size - padding
        if tuple(expected) != self.shape:
            raise ValueError(
                f"scale shape {tuple(scale_e8m0.shape)} (block_size={block_size}, "
                f"padding={padding}) implies logical shape {tuple(expected)}, "
                f"but the payload implies {self.shape}"
            )

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical (unquantized) shape."""
        s = list(self.data.shape)
        if self.elem_dtype == dtypes.float4_e2m1:
            s[self.block_dim] = s[self.block_dim] * 2 - self.padding % 2
        elif self.fp4_pack == "quarters":  # 3 byte planes hold 4 code planes
            s[self.block_dim] = s[self.block_dim] * 4 // 3
        elif self.fp4_pack == "halves":  # fp8: one u16 word per two elements
            s[self.block_dim] = s[self.block_dim] * 2
        return tuple(s)

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self) -> str:
        return (
            f"MXTensor(elem_dtype={self.elem_dtype}, shape={self.shape}, "
            f"block_size={self.block_size}, block_dim={self.block_dim}, "
            f"fp4_pack={self.fp4_pack})"
        )

    def _replace(self, **kw) -> "MXTensor":
        args = dict(
            scale_e8m0=self.scale_e8m0, data=self.data, elem_dtype=self.elem_dtype,
            block_size=self.block_size, orig_dtype=self.orig_dtype,
            padding=self.padding, block_dim=self.block_dim, fp4_pack=self.fp4_pack,
        )
        args.update(kw)
        return MXTensor(**args)

    @staticmethod
    def to_mx(data_hp: torch.Tensor, elem_dtype, block_size: int = 32) -> "MXTensor":
        """Quantize a bf16 tensor along its last dim (padded to a block
        multiple; the payload is sliced back to the logical size)."""
        elem = dtypes.as_dtype(elem_dtype)
        size = data_hp.shape[-1]
        padding = (block_size - size % block_size) % block_size
        if padding:
            data_hp = torch.nn.functional.pad(data_hp, (0, padding))
        scale, data_lp = quantize_mx(data_hp, elem.name, block_size)
        if elem == dtypes.float4_e2m1:
            size = math.ceil(size / 2)
        return MXTensor(scale, data_lp[..., :size], elem, block_size, data_hp.dtype, padding)

    @property
    def T(self) -> "MXTensor":
        """2-D transpose; payload and scale transpose together."""
        if self.ndim != 2 or self.fp4_pack != "pair":
            raise ValueError("T needs a 2-D tensor in the pair layout")
        return self._replace(
            scale_e8m0=self.scale_e8m0.t().contiguous(),
            data=self.data.t().contiguous(),
            block_dim=1 - self.block_dim,
        )

    def to_fp4_halves(self) -> "MXTensor":
        """Repack a 2-D K-major fp4 payload into the kernel "halves" layout
        (byte p holds elements (p, p + K/2)); needs K % 64 == 0 so each half
        stays 32-block aligned."""
        if not (self.elem_dtype == dtypes.float4_e2m1 and self.fp4_pack == "pair"):
            raise ValueError("to_fp4_halves needs an fp4 tensor in the pair layout")
        if not (self.ndim == 2 and self.block_dim == 0 and self.padding == 0):
            raise ValueError("to_fp4_halves needs a 2-D K-major unpadded tensor")
        K = self.shape[0]
        if K % 64:
            raise ValueError(f"halves layout needs K % 64 == 0, got {K}")
        codes = unpack_uint4(self.data, packing_dim=0)
        data = ((codes[: K // 2] << 4) | (codes[K // 2 :] & 0xF)).to(torch.uint8)
        return self._replace(data=data.contiguous(), fp4_pack="halves")

    def _halves_to_pair(self) -> "MXTensor":
        codes = torch.cat([self.data >> 4, self.data & 0xF], dim=0)
        return self._replace(data=pack_uint4(codes, packing_dim=0), fp4_pack="pair")

    def _check_kernel_layout(self, what: str, elems, k_multiple: int) -> int:
        if self.elem_dtype not in elems or self.fp4_pack != "pair":
            raise ValueError(f"{what} needs a {'/'.join(e.name for e in elems)} tensor in the pair layout")
        if not (self.ndim == 2 and self.block_dim == 0 and self.padding == 0):
            raise ValueError(f"{what} needs a 2-D K-major unpadded tensor")
        K = self.shape[0]
        if K % k_multiple:
            raise ValueError(f"{what} needs K % {k_multiple} == 0, got {K}")
        return K

    def to_fp8_halves(self) -> "MXTensor":
        """Repack a 2-D K-major fp8 payload into K3's "halves" layout: uint16
        word p holds the codes of elements p (high byte) and p + K/2 (low
        byte), the same bytes per element as the flat layout.  Needs K % 64
        == 0.  The JAX kernel's decode needs every scale >= 10 (no decoded
        value below the bf16 normal range); ``MXInferenceLinear`` checks that
        before it repacks."""
        K = self._check_kernel_layout("to_fp8_halves", (dtypes.float8_e4m3,), 64)
        codes = self.data.to(torch.int32)
        words = (codes[: K // 2] << 8) | codes[K // 2:]
        # through int16 (wrapping), as PyTorch casts few ops to and from uint16
        return self._replace(data=words.to(torch.int16).view(torch.uint16).contiguous(), fp4_pack="halves")

    def _fp8_halves_to_flat(self) -> "MXTensor":
        return self._replace(data=fp8_halves_to_codes(self.data).to(torch.uint8), fp4_pack="pair")

    def to_fp6_quarters(self) -> "MXTensor":
        """Repack a 2-D K-major fp6 payload into B8's planar "quarters"
        layout: the codes q0..q3 of the four K quarters go into three byte
        planes of K/4 rows, ``P0 = q0 << 2 | q3 >> 4``, ``P1 = q1 << 2 | (q3 >>
        2) & 3``, ``P2 = q2 << 2 | q3 & 3`` (4 codes per 3 bytes).  Needs K %
        128 == 0, so that each quarter stays 32-block aligned."""
        K = self._check_kernel_layout("to_fp6_quarters", (dtypes.float6_e3m2, dtypes.float6_e2m3), 128)
        q = K // 4
        c = self.data.to(torch.int32)
        q0, q1, q2, q3 = c[:q], c[q:2 * q], c[2 * q:3 * q], c[3 * q:]
        planes = [(q0 << 2) | (q3 >> 4), (q1 << 2) | ((q3 >> 2) & 3), (q2 << 2) | (q3 & 3)]
        return self._replace(data=torch.cat(planes, dim=0).to(torch.uint8), fp4_pack="quarters")

    def _quarters_to_flat(self) -> "MXTensor":
        return self._replace(data=fp6_quarters_to_codes(self.data).to(torch.uint8), fp4_pack="pair")

    def to_int8_domain(self) -> "MXTensor":
        """Exact MXINT8 re-coding of fp4 and fp6 e2m3 tensors (int8 passes
        through): every fp4 value is a multiple of 2^-1 and every e2m3 value
        of 2^-3, so ``value = intval * 2^(se - k - 127)`` with ``intval =
        value * 2^k`` (at most 12 / 60) and k = 1 / 3: the same values, one
        int8 code per element.  Blocks whose scale is below k flush to zero
        (their values are below about 2^-124 of the format's maximum)."""
        if self.elem_dtype == dtypes.int8:
            return self
        if self.padding:
            raise ValueError("int8-domain re-coding of a padded tensor")
        if self.elem_dtype == dtypes.float4_e2m1:
            if self.fp4_pack == "halves":
                return self._halves_to_pair().to_int8_domain()
            codes = unpack_uint4(self.data, packing_dim=self.block_dim).to(torch.int32)
            mag = codes & 7
            # value * 2: {0, .5, 1, 1.5, 2, 3, 4, 6} -> {0, 1, 2, 3, 4, 6, 8, 12}
            intmag = torch.where(mag < 4, mag, (4 + 2 * (mag & 1)) << ((mag >> 1) - 2).clamp(min=0))
            sign, k_off = codes & 8, 1
        elif self.elem_dtype == dtypes.float6_e2m3:
            if self.fp4_pack != "pair":
                raise ValueError("re-code fp6 e2m3 from the flat layout")
            codes = self.data.to(torch.int32)
            e, m = (codes >> 3) & 3, codes & 7
            # value * 8: subnormal m, normal (8 + m) << (e - 1); at most 60
            intmag = torch.where(e == 0, m, (8 + m) << (e - 1).clamp(min=0))
            sign, k_off = codes & 0x20, 3
        else:
            raise ValueError(f"{self.elem_dtype.name} values are not int8-representable")
        se = self.scale_e8m0.to(torch.int32)
        keep = se >= k_off
        data = torch.where(sign > 0, -intmag, intmag)
        data = torch.where(keep.repeat_interleave(self.block_size, dim=self.block_dim), data, 0)
        scale = torch.where(keep, se - k_off, 0).to(torch.uint8)
        return self._replace(scale_e8m0=scale, data=data.to(torch.int8), elem_dtype=dtypes.int8,
                             fp4_pack="pair")

    def to_dtype(self, target_dtype: torch.dtype) -> torch.Tensor:
        """Dequantize (plain PyTorch; used off the CUDA main path)."""
        if self.fp4_pack == "halves":
            if self.elem_dtype == dtypes.float8_e4m3:
                return self._fp8_halves_to_flat().to_dtype(target_dtype)
            return self._halves_to_pair().to_dtype(target_dtype)
        if self.fp4_pack == "quarters":
            return self._quarters_to_flat().to_dtype(target_dtype)
        data_lp = self.data
        bd = self.block_dim
        org_size = data_lp.shape[bd]
        if self.elem_dtype == dtypes.float4_e2m1:
            org_size = org_size * 2 - self.padding % 2
        if self.padding:
            pad = self.padding // 2 if self.elem_dtype == dtypes.float4_e2m1 else self.padding
            widths = [0, 0] * (data_lp.dim() - 1 - bd) + [0, pad]
            data_lp = torch.nn.functional.pad(data_lp, widths)
        out = dequantize_mx(
            data_lp, self.scale_e8m0, self.elem_dtype.name, self.block_size, target_dtype, bd
        )
        return out.narrow(bd, 0, org_size) if self.padding else out


INT8_DOMAIN_FORMATS = ("float4_e2m1", "float6_e2m3")  # re-coded exactly as MXINT8 by quantize_stacked


def quantize_stacked(w_km: torch.Tensor, elem_dtype_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked K-major expert weights ``(E, K, N)`` bf16 -> codes ``(E, K, N)``
    and scales ``(E, K/32, N)``, blocked along K, one byte per code
    (``MXInferenceMixtralMoeBlockGrouped._quantize_stacked`` in
    ``torchmx_tpu/layers/mx_mixtral_moe.py``).  fp4 and fp6 e2m3 quantize on
    their own grid and are then re-coded exactly as MXINT8
    (:meth:`MXTensor.to_int8_domain`, int8 codes); the other formats keep
    their codes (uint8; int8 for MXINT8).  One expert matrix at a time, so
    the temporaries stay the size of one ``(K, N)`` matrix."""
    E, K, N = w_km.shape
    codes = scales = None
    for e in range(E):
        t = MXTensor.to_mx(w_km[e].to(torch.bfloat16).t().contiguous(), elem_dtype_name, 32)
        if elem_dtype_name in INT8_DOMAIN_FORMATS:
            t = t.to_int8_domain()
        if codes is None:
            codes = torch.empty((E, K, N), dtype=t.data.dtype, device=w_km.device)
            scales = torch.empty((E, K // 32, N), dtype=torch.uint8, device=w_km.device)
        codes[e] = t.data.t()
        scales[e] = t.scale_e8m0.t()
    return codes, scales
