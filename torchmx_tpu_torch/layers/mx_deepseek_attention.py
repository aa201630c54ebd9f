"""MX-quantized DeepSeek-V3 MLA attention and MoE (``torchmx_tpu/layers/
mx_deepseek_attention.py``).

* :class:`MXInferenceMLAAttention`: every projection becomes an
  ``MXInferenceLinear``; the latent-space norms stay high precision.  The
  first query projection (``q_proj``, or ``q_a_proj`` with a q LoRA rank)
  and ``kv_a_proj_with_mqa`` read the same x, fake-quantized once for both
  where their matmuls take K2 first (``shared_activation_fq``, as the Llama
  layers share it among q/k/v), bit for bit each linear quantizing its own.
  The absorbed products contract the **dequantized** ``kv_b_proj`` weight,
  the values the MX matmul would see; JAX dequantizes it at every call, the
  port once, when the layer is built (the same values).
* :class:`MXInferenceDeepseekV3MoE` (per-expert) and
  :class:`MXInferenceDeepseekV3MoEGrouped` (stacked codes, B12): the Mixtral
  MX blocks with DeepSeek's routing (``models/deepseek.DeepseekV3MoE``): the
  f32 router and its correction bias stay high precision, the shared
  experts quantize like a dense MLP (``MXInferenceLlamaMLP``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import QAttentionConfig, QLinearConfig
from ..models.deepseek import DeepseekV3MoE, MLAAttention
from .linear import MXInferenceLinear, shared_activation_fq
from .mx_llama_attention import MXInferenceLlamaMLP
from .mx_mixtral_moe import MXInferenceMixtralMoeBlock, MXInferenceMixtralMoeBlockGrouped, _RouterAlias


class MXInferenceMLAAttention(MLAAttention):
    @classmethod
    def from_float(cls, mod: MLAAttention, qconfig: QAttentionConfig) -> "MXInferenceMLAAttention":
        if not isinstance(mod, MLAAttention):
            raise TypeError(f"mod must be an MLAAttention, got {type(mod)}")
        if any((qconfig.query_config, qconfig.key_config, qconfig.value_config, qconfig.attention_weights_config)):
            raise NotImplementedError(
                "Q/K/V/attention-weights quantization configs do not apply to MLA attention (its contractions "
                "run in latent space); quantize the latent cache through kv_cache_config instead")
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        for name in ("config", "layer_idx", "num_heads", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                     "kv_lora_rank", "qk_head_dim", "scaling"):
            setattr(self, name, getattr(mod, name))
        self.qconfig = qconfig
        p = qconfig.projection_config
        names = ("q_a_proj", "q_b_proj") if mod.config.q_lora_rank else ("q_proj",)
        for name in names + ("kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            setattr(self, name, MXInferenceLinear.from_float(getattr(mod, name), p))
        if mod.config.q_lora_rank:
            self.q_a_layernorm = mod.q_a_layernorm
        self.kv_a_layernorm = mod.kv_a_layernorm
        # K-major (r, n*(dn+dv)) MX weight -> dequantized torch layout, split per head.
        n, dn = self.num_heads, self.qk_nope_head_dim
        w = self.kv_b_proj.weight.to_dtype(torch.bfloat16).t().reshape(n, dn + self.v_head_dim, self.kv_lora_rank)
        self.register_buffer("w_kb", w[:, :dn].contiguous(), persistent=False)
        self.register_buffer("w_vb", w[:, dn:].contiguous(), persistent=False)
        return self

    def _project_inputs(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        first = self.q_a_proj if self.config.q_lora_rank else self.q_proj
        x_fq = shared_activation_fq(x, first, self.kv_a_proj_with_mqa)
        if x_fq is None:
            return super()._project_inputs(x)
        q = first.apply_prequantized(x_fq)
        if self.config.q_lora_rank:
            q = self.q_b_proj(self.q_a_layernorm(q))
        return q, self.kv_a_proj_with_mqa.apply_prequantized(x_fq)

    def _kv_b_halves(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.w_kb, self.w_vb

    def extra_repr(self) -> str:
        return f"qconfig={self.qconfig}"


class _DeepseekRouting:
    """What the DeepSeek MX blocks add to the Mixtral ones: the router alias
    carrying the correction bias (``gate.e_score_correction_bias``), read by
    ``DeepseekV3MoE._route_raw``, and the shared experts."""

    @property
    def gate(self):
        alias = _RouterAlias(self.gate_weight)
        alias.e_score_correction_bias = self.e_score_bias
        return alias

    @staticmethod
    def convert(block: nn.Module, mod: DeepseekV3MoE, qconfig: QLinearConfig) -> nn.Module:
        """Turn a Mixtral MX block quantized from ``mod`` into its DeepSeek class."""
        block.__class__ = MXInferenceDeepseekV3MoEGrouped if block.grouped else MXInferenceDeepseekV3MoE
        block.e_score_bias = mod.gate.e_score_correction_bias.detach().to(torch.float32).clone()
        block.shared_experts = MXInferenceLlamaMLP.from_float(mod.shared_experts, qconfig)
        return block


class MXInferenceDeepseekV3MoE(_DeepseekRouting, MXInferenceMixtralMoeBlock, DeepseekV3MoE):
    """Per-expert ``MXInferenceLinear``s (dense-exact / capacity modes); the
    grouped one when ``mod.grouped`` is set."""

    @classmethod
    def from_float(cls, mod: DeepseekV3MoE, qconfig: QLinearConfig) -> nn.Module:
        if not isinstance(mod, DeepseekV3MoE):
            raise TypeError(f"mod must be a DeepseekV3MoE, got {type(mod)}")
        return cls.convert(MXInferenceMixtralMoeBlock.from_float(mod, qconfig), mod, qconfig)


class MXInferenceDeepseekV3MoEGrouped(_DeepseekRouting, MXInferenceMixtralMoeBlockGrouped, DeepseekV3MoE):
    """Stacked one-byte MX codes through B12 (``MXInferenceMixtralMoeBlockGrouped``)."""
