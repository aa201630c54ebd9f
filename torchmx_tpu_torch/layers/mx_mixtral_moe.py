"""MX-quantized Mixtral sparse-MoE blocks (``torchmx_tpu/layers/
mx_mixtral_moe.py``).  Both keep the router in high precision: its weight is
a raw ``(E, H)`` bf16 tensor applied as ``x_t @ W.T``, not a ``Linear``
child, so the leftover ``quantize_linear_`` pass never reaches it (a
quantization bin flip there would change which experts run).

* :class:`MXInferenceMixtralMoeBlock`: per-expert ``MXInferenceLinear``s
  (each expert GEMM through the layout's matmul kernel, with its activation
  fake-quantize), serving the dense-exact and capacity modes.
* :class:`MXInferenceMixtralMoeBlockGrouped`: stacked one-byte MX codes
  ``(E, K, N)`` and scales ``(E, K/32, N)``, the layout B12 reads, for the
  dropless grouped mode; the activations are fake-quantized apart (K2 on
  the card).  fp4 and fp6 e2m3 weights are quantized on their own grid and
  re-coded exactly as MXINT8 (``kernel_elem`` "int8"), so every weight
  format runs through the one-byte kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import QLinearConfig
from ..models.mixtral import MixtralSparseMoeBlock, router_logits, swiglu_f32
from ..mx_array import INT8_DOMAIN_FORMATS, quantize_stacked
from ..ops import moe
from ..ops.quantize import mx_fake_quantize
from .linear import MXInferenceLinear


class _RouterAlias:
    """Exposes the router tensor as ``.weight`` under the checkpoint's name
    ``gate`` (not a module)."""

    def __init__(self, weight):
        self.weight = weight


class MXInferenceMixtralMoeBlock(MixtralSparseMoeBlock):
    def __init__(self, config, gate_weight, experts_w1, experts_w3, experts_w2, qconfig: QLinearConfig,
                 capacity_factor=None):
        nn.Module.__init__(self)  # the stacked bf16 weights are replaced by per-expert linears
        self.config = config
        self.qconfig = qconfig
        self.capacity_factor = capacity_factor
        self.grouped = False
        self.grouped_tm = 128
        self.gate_weight = gate_weight
        self.experts_w1 = nn.ModuleList(experts_w1)
        self.experts_w3 = nn.ModuleList(experts_w3)
        self.experts_w2 = nn.ModuleList(experts_w2)

    @classmethod
    def from_float(cls, mod: MixtralSparseMoeBlock, qconfig: QLinearConfig):
        """The per-expert block, or the grouped one when ``mod.grouped`` is set."""
        if not isinstance(mod, MixtralSparseMoeBlock):
            raise TypeError(f"mod must be a MixtralSparseMoeBlock, got {type(mod)}")
        if getattr(mod, "grouped", False):
            return MXInferenceMixtralMoeBlockGrouped.from_float(mod, qconfig)
        e = mod.config.num_local_experts

        def linears(w):  # K-major (E, in, out) -> torch layout (out, in) per expert
            return [MXInferenceLinear.from_weights(w[i].t(), None, qconfig) for i in range(e)]

        return cls(mod.config, mod.gate.weight.detach().clone(), linears(mod.w1), linears(mod.w3),
                   linears(mod.w2), qconfig, capacity_factor=mod.capacity_factor)

    @property
    def gate(self):
        return _RouterAlias(self.gate_weight)

    def _router_logits(self, x_t):
        return router_logits(x_t, self.gate_weight)

    def _expert_ffn_grouped(self, x_sorted, tile_expert, tile_rows, tm, **bounds):
        raise NotImplementedError(
            "this block serves the dense-exact / capacity modes; grouped "
            "routing quantizes into MXInferenceMixtralMoeBlockGrouped "
            "(set mlp.grouped = True BEFORE quantize_llm_)"
        )

    def _expert_ffn_all(self, x_t):
        outs = [self.experts_w2[i](swiglu_f32(self.experts_w1[i](x_t), self.experts_w3[i](x_t)))
                for i in range(self.config.num_local_experts)]
        return torch.stack(outs, dim=0)  # (E, T, H)

    def _expert_ffn_batched(self, xe):
        outs = [self.experts_w2[i](swiglu_f32(self.experts_w1[i](xe[i]), self.experts_w3[i](xe[i])))
                for i in range(self.config.num_local_experts)]
        return torch.stack(outs, dim=0)  # (E, C, H)


class MXInferenceMixtralMoeBlockGrouped(MixtralSparseMoeBlock):
    """Grouped-routing quantized MoE block over stacked MX codes (see the
    module docstring).  ``codes`` / ``scales``: ``{"w1", "w3", "w2": tensor}``."""

    SUPPORTED = ("float8_e4m3", "float6_e3m2", "float6_e2m3", "float4_e2m1", "int8")

    def __init__(self, config, gate_weight, codes: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor],
                 qconfig: QLinearConfig, kernel_elem: str):
        nn.Module.__init__(self)
        self.config = config
        self.qconfig = qconfig
        self.capacity_factor = None
        self.grouped = True
        self.grouped_tm = 128
        self.kernel_elem = kernel_elem  # the format B12 decodes: int8 for fp4 and fp6 e2m3
        self.gate_weight = gate_weight
        for name in ("w1", "w3", "w2"):
            setattr(self, f"{name}_codes", codes[name])
            setattr(self, f"{name}_scale", scales[name])

    @classmethod
    def from_float(cls, mod: MixtralSparseMoeBlock, qconfig: QLinearConfig):
        elem = qconfig.weights_config.elem_dtype_name
        if elem not in cls.SUPPORTED:
            raise NotImplementedError(f"grouped MX MoE supports weight formats {cls.SUPPORTED}; got {elem}")
        if qconfig.weights_config.block_size != 32:
            raise ValueError("the grouped MX MoE block takes block size 32")
        codes, scales = {}, {}
        for name in ("w1", "w3", "w2"):
            codes[name], scales[name] = quantize_stacked(getattr(mod, name).detach(), elem)
        kernel_elem = "int8" if elem in INT8_DOMAIN_FORMATS else elem
        return cls(mod.config, mod.gate.weight.detach().clone(), codes, scales, qconfig, kernel_elem)

    @property
    def gate(self):
        return _RouterAlias(self.gate_weight)

    def _router_logits(self, x_t):
        return router_logits(x_t, self.gate_weight)

    def _act_fq(self, x):
        a = self.qconfig.activations_config
        if a is None:
            return x
        return mx_fake_quantize(x.contiguous(), a.elem_dtype, a.block_size)

    def _expert_ffn_grouped(self, x_sorted, tile_expert, tile_rows, tm, **bounds):
        elem = self.kernel_elem

        def gmm(x, name):
            return moe.grouped_matmul(x, getattr(self, f"{name}_codes"), tile_expert, tile_rows, tm=tm,
                                      w_scale=getattr(self, f"{name}_scale"), elem_name=elem, **bounds)

        xq = self._act_fq(x_sorted)
        return gmm(self._act_fq(swiglu_f32(gmm(xq, "w1"), gmm(xq, "w3"))), "w2")

    def _expert_ffn_all(self, x_t):
        raise NotImplementedError(
            "this block is grouped-only (stacked MX codes); use the "
            "per-expert MXInferenceMixtralMoeBlock for dense/capacity modes"
        )

    _expert_ffn_batched = _expert_ffn_all
