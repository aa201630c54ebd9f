"""MX matmul ops (``torchmx_tpu/ops/matmul.py:55-132``, with the dispatch of
``ops/pallas_matmul.py:849-920, 1260-1310``).

``b`` is a K-major weight :class:`MXTensor` (payload ``(K, N)`` blocked on K,
or one of the kernel layouts of it).  Each weight layout has its kernel (the
CUDA kernel on a CUDA tensor, its plain version on a CPU tensor):

* fp4 or fp8 "halves" -> K3 (``mx_matmul_fp4_halves`` / ``mx_matmul_fp8_halves``);
* fp4 "pair" -> B7 (``mx_matmul_fp4_pair``);
* fp6 "quarters" -> B8 (``mx_matmul_fp6q``);
* one code per byte (fp8, fp6, int8) -> B6 (``mx_matmul_1byte``);
* int8 activations with an int8 weight, or, under ``TORCHMX_FP8_DOT=1``, fp8
  activations with a flat fp8 weight, at M <= 256 -> B9
  (``mx_matmul_int8dot``), from ``mx_dynamic_matmul`` only.

Any other weight (a padded or n-d tensor, another block size) runs the plain
dequantize-then-matmul path, on the CPU only: on the card a weight no kernel
takes raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import dtypes
from .. import env_variables as env
from ..mx_array import MXTensor
from .backend import on_cuda
from . import cuda_matmul as k3
from . import cuda_matmul_formats as kf
from .quantize import mx_fake_quantize


def _kernel_layout(b) -> bool:
    return (
        isinstance(b, MXTensor) and b.ndim == 2 and b.block_dim == 0
        and b.padding == 0 and b.block_size == 32
    )


def _kernel_of(w: MXTensor):
    """(wrapper(x2d, w, act_fq), activation formats it fuses) for the
    weight's layout, or None when no kernel takes it."""
    if not _kernel_layout(w):
        return None
    name = w.elem_dtype.name
    if w.fp4_pack == "halves":
        fn = k3.mx_matmul_fp4_halves if name == "float4_e2m1" else k3.mx_matmul_fp8_halves
        return (lambda x, w, act: fn(x, w.data, w.scale_e8m0, act)), k3.ACT_FQ_FORMATS
    if w.fp4_pack == "quarters":
        return (lambda x, w, act: kf.mx_matmul_fp6q(x, w.data, w.scale_e8m0, name, act)), kf.ACT_FQ_FP6Q
    if name == "float4_e2m1":
        return (lambda x, w, act: kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, act)), kf.ACT_FQ_FP4_PAIR
    if name in kf.CODE_FORMATS_1BYTE:
        return (lambda x, w, act: kf.mx_matmul_1byte(x, w.data, w.scale_e8m0, name, act)), kf.ACT_FQ_1BYTE
    return None


def _rows(x: torch.Tensor, fn) -> torch.Tensor:
    lead = x.shape[:-1]
    out = fn(x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous())
    return out.reshape(*lead, out.shape[-1])


def _plain_matmul(a: torch.Tensor, b: MXTensor) -> torch.Tensor:
    if on_cuda(a):
        raise ValueError(f"no CUDA kernel takes the weight {b}")
    out = a.to(torch.bfloat16).to(torch.float32) @ b.to_dtype(torch.bfloat16).to(torch.float32)
    return out.to(torch.bfloat16)


def mx_matmul(a: torch.Tensor, b: MXTensor) -> torch.Tensor:
    """``a @ b`` in bf16 with fp32 accumulation; ``a`` is used as it is
    (e.g. already fake-quantized by :func:`shared_activation_fq`)."""
    kernel = _kernel_of(b)
    if kernel is not None:
        return _rows(a, lambda x: kernel[0](x, b, None))
    return _plain_matmul(a, b)


def int8dot_format(x_rows: int, w: MXTensor, act_name: str) -> Optional[bool]:
    """B9's variant for ``mx_dynamic_matmul`` (False: int8, True: e4m3), or
    None where B9 does not apply (``int8dot_any`` / ``fp8dot_any``): int8
    activations with an int8(-domain) weight, or fp8 activations with a flat
    fp8 weight under ``TORCHMX_FP8_DOT=1``; at most ``INT8DOT_MAX_M`` rows."""
    if not (_kernel_layout(w) and 0 < x_rows <= kf.INT8DOT_MAX_M):
        return None
    if act_name == "int8" and w.elem_dtype == dtypes.int8:
        return False
    if (act_name == "float8_e4m3" and env.TORCHMX_FP8_DOT == "1"
            and w.elem_dtype == dtypes.float8_e4m3 and w.fp4_pack == "pair"):
        return True
    return None


def mx_dynamic_matmul(
    x: torch.Tensor, w: MXTensor, act_elem_dtype_name: str, act_block_size: int = 32
) -> torch.Tensor:
    """Fake-quantize ``x`` per MX block, then ``x_q @ w``.  With block size
    32: B9 where :func:`int8dot_format` says so; else, where the weight's
    wrapper takes the activation format, the wrapper applies it (in its
    kernel's prologue, or by K2 first: B7, B8 and K3 at every M, B6 above
    64 rows), bit-identical to the two-pass form; else the two passes (K2,
    then the weight's kernel)."""
    name = dtypes.as_dtype(act_elem_dtype_name).name
    if act_block_size == 32:
        fp8 = int8dot_format(x.numel() // x.shape[-1], w, name)
        if fp8 is not None:
            return _rows(x, lambda x2: kf.mx_matmul_int8dot(x2, w.data, w.scale_e8m0, fp8))
        kernel = _kernel_of(w)
        if kernel is not None and name in kernel[1]:
            return _rows(x, lambda x2: kernel[0](x2, w, name))
    x_fq = mx_fake_quantize(x.to(torch.bfloat16), name, act_block_size)
    return mx_matmul(x_fq, w)
