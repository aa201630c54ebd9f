"""Module-surgery quantization (``torchmx_tpu/quant_api.py``) over
``nn.Module`` trees, and a layer-by-layer builder for models too large to
hold in bf16 next to their quantized copy.

The registries map a block's exact type to its MX version, as the JAX
package's do, limited to the ported families (Llama, Qwen2, Mistral,
Mixtral, DeepSeek-V3).  A ``MixtralSparseMoeBlock`` or ``DeepseekV3MoE``
becomes the per-expert MX block, or the stacked grouped one when its
``grouped`` flag is set."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Type

import torch
from torch import nn

from .config import QAttentionConfig, QLinearConfig
from .layers.linear import Linear, MXInferenceLinear
from .layers.mx_llama_attention import MXInferenceLlamaAttention, MXInferenceLlamaMLP
from .layers.mx_mistral_attention import MXInferenceMistralAttention, MXInferenceMistralMLP
from .layers.mx_qwen2_attention import MXInferenceQwen2Attention, MXInferenceQwen2MLP
from .layers.mx_deepseek_attention import MXInferenceDeepseekV3MoE, MXInferenceMLAAttention
from .layers.mx_mixtral_moe import MXInferenceMixtralMoeBlock
from .models.deepseek import DeepseekV3MoE, MLAAttention
from .models.llama import LlamaAttention, LlamaConfig, LlamaForCausalLM, LlamaMLP
from .models.mistral import MistralAttention, MistralMLP
from .models.mixtral import MixtralSparseMoeBlock
from .models.qwen2 import Qwen2Attention, Qwen2MLP
from .ops.backend import DeviceLike, resolve_device

ATTENTION_LAYERS: Dict[Type, Type] = {
    Qwen2Attention: MXInferenceQwen2Attention,
    MLAAttention: MXInferenceMLAAttention,
    MistralAttention: MXInferenceMistralAttention,
    LlamaAttention: MXInferenceLlamaAttention,
}

MLP_LAYERS: Dict[Type, Type] = {
    Qwen2MLP: MXInferenceQwen2MLP,
    DeepseekV3MoE: MXInferenceDeepseekV3MoE,
    MistralMLP: MXInferenceMistralMLP,
    MixtralSparseMoeBlock: MXInferenceMixtralMoeBlock,
    LlamaMLP: MXInferenceLlamaMLP,
}


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
        if type(child) in ATTENTION_LAYERS:
            setattr(model, name, ATTENTION_LAYERS[type(child)].from_float(child, qattention))
        elif type(child) in MLP_LAYERS:
            setattr(model, name, MLP_LAYERS[type(child)].from_float(child, qmlp))
        else:
            _swap_blocks(child, qattention, qmlp)


def quantize_llm_(model: nn.Module, qattention_config: QAttentionConfig,
                  qmlp_config: QLinearConfig) -> nn.Module:
    """Swap attention and MLP blocks for their MX versions, then quantize the
    remaining plain linears (``lm_head``) with ``qmlp_config``, in place."""
    _swap_blocks(model, qattention_config, qmlp_config)
    return quantize_linear_(model, qmlp_config)


def build_quantized(
    model_cls: Type[LlamaForCausalLM],
    config: LlamaConfig,
    qattention_config: QAttentionConfig,
    qmlp_config: QLinearConfig,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    prepare_layer: Optional[Callable[[nn.Module], None]] = None,
) -> LlamaForCausalLM:
    """A seeded random (or zero) causal LM of ``model_cls`` (Llama, Qwen2,
    Mistral, Mixtral, DeepSeek-V3), made and quantized one decoder layer at a
    time on ``device``: the whole bf16 model is never held.  ``prepare_layer`` sees each bf16
    layer before it is quantized (e.g. to set ``mlp.grouped``)."""
    device = resolve_device(device)
    model = model_cls(dataclasses.replace(config, num_hidden_layers=0), device, generator)
    model.config = config
    model.model.config = config
    quantize_linear_(model, qmlp_config)  # lm_head
    for i in range(config.num_hidden_layers):
        layer = model.model.layer_cls(config, i, device, generator)
        if prepare_layer is not None:
            prepare_layer(layer)
        quantize_llm_(layer, qattention_config, qmlp_config)
        model.model.layers.append(layer)
    return model


def build_quantized_llama(config: LlamaConfig, qattention_config: QAttentionConfig, qmlp_config: QLinearConfig,
                          device: DeviceLike = None, generator: Optional[torch.Generator] = None) -> LlamaForCausalLM:
    """:func:`build_quantized` of a ``LlamaForCausalLM``."""
    return build_quantized(LlamaForCausalLM, config, qattention_config, qmlp_config, device, generator)
