"""MX matmul ops (``torchmx_tpu/ops/matmul.py:55-132``).

``b`` is a K-major weight :class:`MXTensor` (payload ``(K, N)`` blocked on K).
An fp4 weight in the halves layout goes through K3 (the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor).  Any other weight runs the
plain dequantize-then-matmul path, on the CPU only: on the card a weight the
kernel does not take raises.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..mx_array import MXTensor
from .backend import on_cuda
from .cuda_matmul import ACT_FQ_FORMATS, mx_matmul_fp4_halves
from .quantize import mx_fake_quantize


def _is_kernel_weight(b) -> bool:
    return (
        isinstance(b, MXTensor)
        and b.elem_dtype == dtypes.float4_e2m1
        and b.fp4_pack == "halves"
        and b.block_size == 32
    )


def _flat_matmul(x: torch.Tensor, w: MXTensor, act_fq) -> torch.Tensor:
    lead = x.shape[:-1]
    out = mx_matmul_fp4_halves(
        x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous(), w.data, w.scale_e8m0, act_fq
    )
    return out.reshape(*lead, out.shape[-1])


def _plain_matmul(a: torch.Tensor, b: MXTensor) -> torch.Tensor:
    if on_cuda(a):
        raise ValueError(f"no CUDA kernel takes the weight {b}")
    out = a.to(torch.bfloat16).to(torch.float32) @ b.to_dtype(torch.bfloat16).to(torch.float32)
    return out.to(torch.bfloat16)


def mx_matmul(a: torch.Tensor, b: MXTensor) -> torch.Tensor:
    """``a @ b`` in bf16 with fp32 accumulation; ``a`` is used as it is
    (e.g. already fake-quantized by :func:`shared_activation_fq`)."""
    if _is_kernel_weight(b):
        return _flat_matmul(a, b, None)
    return _plain_matmul(a, b)


def mx_dynamic_matmul(
    x: torch.Tensor, w: MXTensor, act_elem_dtype_name: str, act_block_size: int = 32
) -> torch.Tensor:
    """Fake-quantize ``x`` per MX block, then ``x_q @ w``.  With a kernel
    weight, block size 32 and an activation format K3 fuses, the activation
    quantize runs in K3's prologue, at every M, bit-identical to the
    two-pass form."""
    name = dtypes.as_dtype(act_elem_dtype_name).name
    if _is_kernel_weight(w) and act_block_size == 32 and name in ACT_FQ_FORMATS:
        return _flat_matmul(x, w, name)
    x_fq = mx_fake_quantize(x.to(torch.bfloat16), name, act_block_size)
    return mx_matmul(x_fq, w)
