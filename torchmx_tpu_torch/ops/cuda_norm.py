"""``mx_rmsnorm``: the row-wise RMSNorm CUDA kernel (``csrc/mx_rmsnorm.cu``)
and its plain PyTorch version.

It replaces no TPU kernel (the JAX package's RMSNorm is plain jnp,
``torchmx_tpu/models/llama.py:521-526``).  It repairs a fault of the port:
PyTorch's fp32 ``mean`` over 4096 sums in another order at 3-15 rows than at
other row counts, so a row's bytes depended on how many rows shared the call.
The kernel gives each row one warp that sums its squares in a fixed order,
so a row's result does not depend on the other rows.  Same formula:
``x * rsqrt(mean(x * x) + eps) * w`` in fp32, one bf16 rounding.  The plain
version sums the squares by a fixed pairwise tree (``pairwise_sum``), so it
too gives a row the same bytes whatever the row count.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .backend import on_cuda


def pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by a pairwise tree over consecutive elements
    (0+1, 2+3, ..., then the pairs of pairs; a zero pads an odd level):
    elementwise adds only, so a row's sum does not depend on the other rows."""
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = pairwise_sum(xf * xf)[..., None] / xf.shape[-1]
    xf = xf * torch.rsqrt(ms + eps)
    return (xf * weight.to(torch.float32)).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim: the kernel on CUDA tensors (bf16, last dim
    a multiple of 256), the plain version on CPU tensors."""
    if not on_cuda(x, weight):
        return rms_norm_plain(x, weight, eps)
    D = x.shape[-1]
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16 or D % 256 or weight.shape != (D,):
        raise ValueError(f"the RMSNorm kernel takes bf16 rows of a multiple of 256 and a ({D},) bf16 weight, "
                         f"got {x.dtype} {tuple(x.shape)} and {weight.dtype} {tuple(weight.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        cuda_lib.launch("mx_rmsnorm", "mx_rmsnorm_launch", x.data_ptr(), weight.contiguous().data_ptr(),
                        out.data_ptr(), rows, D, float(eps))
    return out
