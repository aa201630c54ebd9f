"""Device-dispatched quantization ops (``torchmx_tpu/ops/quantize.py``)."""

from __future__ import annotations

import torch

from .. import dtypes
from .backend import on_cuda
from .cuda_quantize import mx_fake_quantize_kernel, mx_fake_quantize_plain


def mx_fake_quantize(x: torch.Tensor, elem_dtype, block_size: int = 32) -> torch.Tensor:
    """MX quantize-dequantize round trip of a bf16 tensor along its last dim:
    the K2 kernel on a CUDA tensor, the plain version on a CPU tensor."""
    name = dtypes.as_dtype(elem_dtype).name
    if on_cuda(x):
        return mx_fake_quantize_kernel(x, name, block_size)
    return mx_fake_quantize_plain(x, name, block_size)
