"""``mx_rmsnorm``: the row-wise RMSNorm CUDA kernel (``csrc/mx_rmsnorm.cu``)
and its plain PyTorch version.

It replaces no TPU kernel (the JAX package's RMSNorm is plain jnp,
``torchmx_tpu/models/llama.py:521-526``).  It repairs a fault of the port:
PyTorch's fp32 ``mean`` over 4096 sums in another order at 3-15 rows than at
other row counts, so a row's bytes depended on how many rows shared the call.
The kernel gives each row one CTA that sums its squares in a fixed order,
so a row's result does not depend on the other rows.  Same formula:
``x * rsqrt(mean(x * x) + eps) * w`` in fp32, one bf16 rounding.  The plain
version sums the squares by a fixed pairwise tree (``pairwise_sum``), so it
too gives a row the same bytes whatever the row count.

With an activation format the norm is fused with K2 (``act``): the kernel
fake-quantizes the row it has rounded to bf16 in registers, one launch in
place of two, and the normed row is never written and read back; the result
is ``mx_fake_quantize(rms_norm(x))`` bit for bit (the plain version is that
composition).  The layers use it where the norm's whole output goes to
linears that share one K2.
"""

from __future__ import annotations

import torch

from typing import Optional

from . import cuda_lib
from .backend import on_cuda
from .cuda_quantize import mx_fake_quantize_plain


def pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by a pairwise tree over consecutive elements
    (0+1, 2+3, ..., then the pairs of pairs; a zero pads an odd level):
    elementwise adds only, so a row's sum does not depend on the other rows."""
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """The norm; with ``act`` (an activation format), K2's plain version of it."""
    xf = x.to(torch.float32)
    ms = pairwise_sum(xf * xf)[..., None] / xf.shape[-1]
    xf = xf * torch.rsqrt(ms + eps)
    out = (xf * weight.to(torch.float32)).to(x.dtype)
    return out if act is None else mx_fake_quantize_plain(out.to(torch.bfloat16), act)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dim, fake-quantized to ``act`` (an activation
    format, blocks of 32) where given: the kernel on CUDA tensors (bf16,
    last dim a multiple of 32), the plain version on CPU tensors."""
    if not on_cuda(x, weight):
        return rms_norm_plain(x, weight, eps, act)
    D = x.shape[-1]
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16 or D % 32 or weight.shape != (D,):
        raise ValueError(f"the RMSNorm kernel takes bf16 rows of a multiple of 32 and a ({D},) bf16 weight, "
                         f"got {x.dtype} {tuple(x.shape)} and {weight.dtype} {tuple(weight.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        cuda_lib.launch("mx_rmsnorm", "mx_rmsnorm_launch", x.data_ptr(), weight.contiguous().data_ptr(),
                        out.data_ptr(), rows, D, float(eps), -1 if act is None else cuda_lib.ELEM_CODES[act])
    return out
