"""Element dtype registry for OCP MX (Microscaling) formats.

PyTorch counterpart of ``torchmx_tpu/dtypes.py``: the bit-layout metadata of
every element format (max value, largest binade ``max_pow2``, exponent bias,
field widths).  The constants are contract constants of the OCP MX-v1.0 spec.
Sub-byte formats (fp6/fp4) have no native dtype and are stored as ``uint8``
payloads (fp4 nibble-packed, see ``packing.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, repr=False)
class DType:
    """Bit-layout description of a floating-point / integer element format."""

    name: str
    max: float  # largest representable value
    max_pow2: int  # largest binade
    exponent_bias: int
    exponent_bits: int
    mantissa_bits: int
    has_nan: bool
    has_inf: bool

    def __repr__(self) -> str:
        return self.name

    @property
    def total_bits(self) -> int:
        return 1 + self.exponent_bits + self.mantissa_bits


float8_e4m3 = DType("float8_e4m3", 448.0, 8, 7, 4, 3, True, False)
float6_e3m2 = DType("float6_e3m2", 28.0, 4, 3, 3, 2, False, False)
float6_e2m3 = DType("float6_e2m3", 7.5, 2, 1, 2, 3, False, False)
float4_e2m1 = DType("float4_e2m1", 6.0, 2, 1, 2, 1, False, False)
int8 = DType("int8", 127.0, 6, 0, 0, 7, False, False)

# bfloat16 field layout (the only high-precision input format of the quantizers).
bfloat16 = DType("bfloat16", 3.3895313892515355e38, 127, 127, 8, 7, True, True)

# E8M0 scale (OCP spec 5.4.1): bias 127, exponents -127..127, 0xFF is NaN.
e8m0 = DType("e8m0", 2.0**127, 127, 127, 8, 0, True, False)

SUPPORTED_ELEM_DTYPES = (float8_e4m3, float6_e3m2, float6_e2m3, float4_e2m1, int8)
SUPPORTED_FP_ELEM_DTYPES = (float8_e4m3, float6_e3m2, float6_e2m3, float4_e2m1)
STR_TO_SUPPORTED_ELEM_DTYPE = {d.name: d for d in SUPPORTED_ELEM_DTYPES}

E8M0_EXPONENT_NAN_VAL = 255


def as_dtype(elem) -> DType:
    """Accept a :class:`DType` or its name."""
    return elem if isinstance(elem, DType) else STR_TO_SUPPORTED_ELEM_DTYPE[elem]
