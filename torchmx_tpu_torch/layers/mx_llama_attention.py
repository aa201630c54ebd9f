"""MX-quantized Llama MLP and attention (``torchmx_tpu/layers/
mx_llama_attention.py``): projections become :class:`MXInferenceLinear`, and
an activation read by several projections is fake-quantized once at prefill
sizes, and at every size for fp6-quarters and fp4 / fp8 halves weights
(``shared_activation_fq``), or quantized once by K1 for B9
(``shared_int8dot_x``).  Where the fake-quantize is shared, the decoder layer
has the RMSNorm before the module apply it (``shared_act``; one launch on the
card) and passes the result as ``x_fq``.  Q/K/V quantization is not ported
yet: the MX KV cache is the K/V quantization of this path."""

from __future__ import annotations

from torch import nn

from ..config import QAttentionConfig, QLinearConfig
from ..models.llama import LlamaAttention, LlamaMLP, silu
from .linear import MXInferenceLinear, shared_activation_fq, shared_fq_config, shared_int8dot_x


def _shared_act(rows: int, *linears):
    """The activation format the linears share one fake-quantize in at
    ``rows`` rows (blocks of 32: what the fused norm takes), else None."""
    cfg = shared_fq_config(rows, *linears)
    return cfg.elem_dtype_name if cfg is not None and cfg.block_size == 32 else None


def _project(x, x_fq, *linears):
    """Each linear applied to x: on ``x_fq`` where given (the norm applied
    the shared fake-quantize), else through one shared K2 or one shared K1
    (B9) where they apply, else each on its own."""
    if x_fq is None:
        x_fq = shared_activation_fq(x, *linears)
    if x_fq is not None:
        return tuple(lin.apply_prequantized(x_fq) for lin in linears)
    xq = shared_int8dot_x(x, *linears)
    if xq is not None:
        return tuple(lin.apply_int8dot(xq) for lin in linears)
    return tuple(lin(x) for lin in linears)


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

    def shared_act(self, rows: int):
        """The activation format gate/up share one fake-quantize in at
        ``rows`` rows, which the norm before them may apply; else None."""
        return _shared_act(rows, self.gate_proj, self.up_proj)

    def forward(self, x=None, *, x_fq=None):
        """``x_fq``: the input already fake-quantized to gate/up's shared
        activation grid (``shared_act``), given in place of ``x``."""
        gate, up = _project(x, x_fq, self.gate_proj, self.up_proj)
        return self.down_proj(silu(gate) * up)


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

    def shared_act(self, rows: int):
        """The activation format q/k/v share one fake-quantize in at ``rows``
        rows, which the norm before them may apply; else None."""
        return _shared_act(rows, self.q_proj, self.k_proj, self.v_proj)

    def _project_qkv(self, x, x_fq=None):
        return _project(x, x_fq, self.q_proj, self.k_proj, self.v_proj)
