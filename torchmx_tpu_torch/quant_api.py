"""Module-surgery quantization (``torchmx_tpu/quant_api.py``) over
``nn.Module`` trees, and a layer-by-layer builder for models too large to
hold in bf16 next to their quantized copy."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import QAttentionConfig, QLinearConfig
from .layers.linear import Linear, MXInferenceLinear
from .layers.mx_llama_attention import MXInferenceLlamaAttention, MXInferenceLlamaMLP
from .models.llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
)
from .ops.backend import DeviceLike, resolve_device


def quantize_linear_(model: nn.Module, qconfig: QLinearConfig) -> nn.Module:
    """Swap every plain ``Linear`` for an ``MXInferenceLinear``, in place."""
    for name, child in list(model.named_children()):
        if isinstance(child, Linear):
            setattr(model, name, MXInferenceLinear.from_float(child, qconfig))
        else:
            quantize_linear_(child, qconfig)
    return model


def _swap_blocks(model: nn.Module, qattention: QAttentionConfig, qmlp: QLinearConfig) -> None:
    for name, child in list(model.named_children()):
        if type(child) is LlamaAttention:
            setattr(model, name, MXInferenceLlamaAttention.from_float(child, qattention))
        elif type(child) is LlamaMLP:
            setattr(model, name, MXInferenceLlamaMLP.from_float(child, qmlp))
        else:
            _swap_blocks(child, qattention, qmlp)


def quantize_llm_(model: nn.Module, qattention_config: QAttentionConfig,
                  qmlp_config: QLinearConfig) -> nn.Module:
    """Swap attention and MLP blocks for their MX versions, then quantize the
    remaining plain linears (``lm_head``) with ``qmlp_config``, in place."""
    _swap_blocks(model, qattention_config, qmlp_config)
    return quantize_linear_(model, qmlp_config)


def build_quantized_llama(
    config: LlamaConfig,
    qattention_config: QAttentionConfig,
    qmlp_config: QLinearConfig,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> LlamaForCausalLM:
    """A seeded random (or zero) Llama, made and quantized one decoder layer
    at a time on ``device``: the whole bf16 model is never held."""
    device = resolve_device(device)
    model = LlamaForCausalLM(
        LlamaConfig(**{**config.__dict__, "num_hidden_layers": 0}), device, generator
    )
    model.config = config
    model.model.config = config
    quantize_linear_(model, qmlp_config)  # lm_head
    for i in range(config.num_hidden_layers):
        layer = LlamaDecoderLayer(config, i, device, generator)
        quantize_llm_(layer, qattention_config, qmlp_config)
        model.model.layers.append(layer)
    return model
