"""Linear layers (``torchmx_tpu/layers/linear.py:26-260``): a bf16 ``Linear``
with the torch weight layout ``(out, in)`` and ``MXInferenceLinear``, whose
weight is MX-quantized once and whose activations are quantized per call."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import env_variables as env
from ..config import QLinearConfig
from ..mx_array import MXTensor
from ..ops import cuda_matmul_formats as kf
from ..ops.cuda_matmul_formats import act_fq_first
from ..ops.matmul import int8dot_format, mx_dynamic_matmul, mx_matmul
from ..ops.quantize import mx_fake_quantize


class Linear(nn.Module):
    """Plain bf16 linear, weight ``(out_features, in_features)``; with a
    generator the weight is LeCun-normal, else zeros."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        use_bias: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        w = torch.zeros((out_features, in_features), dtype=torch.bfloat16, device=device)
        if generator is not None:
            std = 1.0 / math.sqrt(in_features)
            w = (torch.randn(w.shape, generator=generator, device=device) * std).to(torch.bfloat16)
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=torch.bfloat16, device=device), requires_grad=False)
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = (x.to(torch.float32) @ self.weight.to(torch.float32).T).to(x.dtype)
        return out if self.bias is None else out + self.bias.to(out.dtype)


def kernel_layout(w: MXTensor) -> MXTensor:
    """The K-major weight ``w`` in the layout its kernel reads (see
    :class:`MXInferenceLinear`).  The fp8 scale bound is checked once, here
    (``_concrete_min_ge`` in the JAX package): a device synchronisation."""
    if not (w.ndim == 2 and w.block_dim == 0 and w.padding == 0 and w.fp4_pack == "pair"):
        return w
    name, K = w.elem_dtype.name, w.shape[0]
    if name in ("float4_e2m1", "float6_e2m3") and env.TORCHMX_INT8_DOMAIN == "1":
        return w.to_int8_domain()
    if name == "float4_e2m1" and K % 512 == 0:
        return w.to_fp4_halves()
    if (name == "float8_e4m3" and K % 512 == 0 and env.TORCHMX_FP8_HALVES == "1"
            and env.TORCHMX_FP8_DOT != "1" and int(w.scale_e8m0.min()) >= 10):
        return w.to_fp8_halves()
    if name in ("float6_e3m2", "float6_e2m3") and K % 1024 == 0 and env.TORCHMX_FP6_PACK == "1":
        return w.to_fp6_quarters()
    return w


class MXInferenceLinear(nn.Module):
    """Linear with an MX weight and dynamically MX-quantized activations.

    The weight is stored K-major (``(in, out)``, blocked on the contraction
    dim) in the layout ``torchmx_tpu/layers/linear.py:88-148`` chooses (the
    stored values are unchanged):

    * fp4 and fp6 e2m3 re-coded as MXINT8 under ``TORCHMX_INT8_DOMAIN=1``;
    * fp4 with ``in % 512 == 0`` in the halves layout (K3), any other fp4
      weight in the pair layout (B7);
    * fp8 with ``in % 512 == 0`` and every scale >= 10 in the halves layout
      (K3), unless ``TORCHMX_FP8_HALVES != "1"`` or ``TORCHMX_FP8_DOT ==
      "1"`` (B9 takes the flat layout);
    * fp6 with ``in % 1024 == 0`` in the quarters layout (B8) unless
      ``TORCHMX_FP6_PACK != "1"``;
    * any other one-byte weight flat (B6)."""

    def __init__(self, weight_mx: MXTensor, bias: Optional[torch.Tensor], qconfig: QLinearConfig):
        super().__init__()
        if weight_mx.block_dim == weight_mx.ndim - 1:
            weight_mx = weight_mx.T  # to K-major
        self.weight = kernel_layout(weight_mx)
        self.bias = bias
        self.qconfig = qconfig
        self.in_features, self.out_features = weight_mx.shape

    @classmethod
    def from_weights(cls, weight: torch.Tensor, bias: Optional[torch.Tensor],
                     qconfig: QLinearConfig) -> "MXInferenceLinear":
        """From a weight in the torch layout ``(out, in)``, quantized along
        ``in`` (``torchmx_tpu/layers/linear.py`` ``from_weights``)."""
        wc = qconfig.weights_config
        w = weight.detach().to(torch.bfloat16).contiguous()
        return cls(MXTensor.to_mx(w, wc.elem_dtype, wc.block_size), bias, qconfig)

    @classmethod
    def from_float(cls, mod: Linear, qconfig: QLinearConfig) -> "MXInferenceLinear":
        return cls.from_weights(mod.weight, None if mod.bias is None else mod.bias.detach(), qconfig)

    def _add_bias(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.bias is None else out + self.bias.to(out.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.qconfig.activations_config
        out = mx_dynamic_matmul(x.to(torch.bfloat16), self.weight, a.elem_dtype_name, a.block_size)
        return self._add_bias(out)

    def apply_prequantized(self, x_fq: torch.Tensor) -> torch.Tensor:
        """Forward on an activation already fake-quantized to this layer's
        activation grid (bit-identical to ``forward`` on the raw one)."""
        return self._add_bias(mx_matmul(x_fq, self.weight))

    def apply_int8dot(self, xq: tuple) -> torch.Tensor:
        """Forward on x as :func:`shared_int8dot_x` quantized it for B9
        (bit-identical to ``forward`` on the raw x)."""
        x2, px_t, xd, fp8, lead = xq
        out = kf.mx_matmul_int8dot(x2, self.weight.data, self.weight.scale_e8m0, fp8, (px_t, xd))
        return self._add_bias(out.reshape(*lead, out.shape[-1]))

    def extra_repr(self) -> str:
        return f"in={self.in_features}, out={self.out_features}, qconfig={self.qconfig}"


def fq_layout(w: MXTensor) -> str:
    """The layout name ``act_fq_first`` takes for the kernel that reads the
    K-major weight ``w``: its fp4_pack for halves and quarters, ``"pair"``
    for an fp4 weight in the pair packing (B7), else ``"1byte"`` (B6)."""
    if w.fp4_pack in ("halves", "quarters"):
        return w.fp4_pack
    return "pair" if w.elem_dtype.name == "float4_e2m1" else "1byte"


def _shared_act_config(linears):
    """The activation config of MX linears that all take the same one, else None."""
    if not linears or not all(isinstance(lin, MXInferenceLinear) for lin in linears):
        return None
    cfg = linears[0].qconfig.activations_config
    return None if any(lin.qconfig.activations_config != cfg for lin in linears[1:]) else cfg


def shared_fq_config(rows: int, *linears):
    """The activation config by which :func:`shared_activation_fq` would
    fake-quantize an x of ``rows`` rows once for ``linears``, where a
    linear's matmul would take x quantized by K2 first (``act_fq_first``: at
    prefill sizes, and at every size for fp6-quarters and fp4 / fp8 halves
    weights); None where sharing does not apply (each linear then quantizes
    its own).  Linears of fp4 pair weights are kept out: B7's own K2 writes
    x in the plane order its kernel reads, which a shared row-major x would
    have to be copied into again."""
    cfg = _shared_act_config(linears)
    if cfg is None:
        return None
    layouts = [fq_layout(lin.weight) for lin in linears]
    if "pair" in layouts or not any(act_fq_first(layout, rows) for layout in layouts):
        return None
    return cfg


def shared_activation_fq(x: torch.Tensor, *linears) -> Optional[torch.Tensor]:
    """``x`` fake-quantized once for several MX linears that read it under
    the same activation config, where :func:`shared_fq_config` says so; else
    None."""
    cfg = shared_fq_config(x.numel() // x.shape[-1], *linears)
    if cfg is None:
        return None
    return mx_fake_quantize(x.to(torch.bfloat16).contiguous(), cfg.elem_dtype, cfg.block_size)


def shared_int8dot_x(x: torch.Tensor, *linears) -> Optional[tuple]:
    """x quantized once by K1's dot-order mode for several MX linears that
    all run B9 on it (``int8dot_format`` of the same variant, the same
    activation config): ``(x as 2-D rows, px_t, xd, fp8, x's leading dims)`` for
    :meth:`MXInferenceLinear.apply_int8dot`, or None."""
    cfg = _shared_act_config(linears)
    if cfg is None or cfg.block_size != 32:
        return None
    rows = x.numel() // x.shape[-1]
    variants = {int8dot_format(rows, lin.weight, cfg.elem_dtype_name) for lin in linears}
    if len(variants) != 1 or None in variants:
        return None
    fp8 = variants.pop()
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    return (x2, *kf.mx_quantize_dot(x2, "float8_e4m3" if fp8 else "int8"), fp8, tuple(x.shape[:-1]))
