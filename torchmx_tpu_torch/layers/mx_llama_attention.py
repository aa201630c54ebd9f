"""MX-quantized Llama MLP and attention (``torchmx_tpu/layers/
mx_llama_attention.py``): projections become :class:`MXInferenceLinear`, and
an activation read by several projections is fake-quantized once at prefill
sizes, and at every size for fp6-quarters and fp4 / fp8 halves weights
(``shared_activation_fq``).  Q/K/V quantization is not ported yet: the MX KV
cache is the K/V quantization of this path."""

from __future__ import annotations

from torch import nn

from ..config import QAttentionConfig, QLinearConfig
from ..models.llama import LlamaAttention, LlamaMLP, silu
from .linear import MXInferenceLinear, shared_activation_fq


class MXInferenceLlamaMLP(nn.Module):
    def __init__(self, gate_proj, up_proj, down_proj, qconfig: QLinearConfig):
        super().__init__()
        self.gate_proj, self.up_proj, self.down_proj = gate_proj, up_proj, down_proj
        self.qconfig = qconfig

    @classmethod
    def from_float(cls, mod: LlamaMLP, qconfig: QLinearConfig) -> "MXInferenceLlamaMLP":
        return cls(
            MXInferenceLinear.from_float(mod.gate_proj, qconfig),
            MXInferenceLinear.from_float(mod.up_proj, qconfig),
            MXInferenceLinear.from_float(mod.down_proj, qconfig),
            qconfig,
        )

    def forward(self, x):
        x_fq = shared_activation_fq(x, self.gate_proj, self.up_proj)
        if x_fq is not None:
            h = silu(self.gate_proj.apply_prequantized(x_fq)) * self.up_proj.apply_prequantized(x_fq)
        else:
            h = silu(self.gate_proj(x)) * self.up_proj(x)
        return self.down_proj(h)


class MXInferenceLlamaAttention(LlamaAttention):
    @classmethod
    def from_float(cls, mod: LlamaAttention, qconfig: QAttentionConfig) -> "MXInferenceLlamaAttention":
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.config, self.layer_idx = mod.config, mod.layer_idx
        self.num_heads, self.num_key_value_heads = mod.num_heads, mod.num_key_value_heads
        self.head_dim, self.sm_scale = mod.head_dim, mod.sm_scale
        self.qconfig = qconfig
        p = qconfig.projection_config
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, MXInferenceLinear.from_float(getattr(mod, name), p))
        return self

    def _project_qkv(self, x):
        x_fq = shared_activation_fq(x, self.q_proj, self.k_proj, self.v_proj)
        if x_fq is None:
            return super()._project_qkv(x)
        return (
            self.q_proj.apply_prequantized(x_fq),
            self.k_proj.apply_prequantized(x_fq),
            self.v_proj.apply_prequantized(x_fq),
        )
