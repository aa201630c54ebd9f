"""Mistral (``torchmx_tpu/models/mistral.py``): the Llama architecture with a
sliding attention window.  Distinct classes, so that the quantization
registry (``quant_api``) can target them by type.

The port's attention (``ops/cuda_attention.cached_attention_any``) takes no
window yet, so a layer whose ``sliding_window`` is not None raises
``NotImplementedError`` when it is built, rather than attend to the whole
prefix.  Checkpoints with ``sliding_window: null`` (Mistral v0.2 and later,
Mixtral) run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .llama import LlamaAttention, LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP, LlamaModel


@dataclasses.dataclass
class MistralConfig(LlamaConfig):
    sliding_window: Optional[int] = 4096


def check_no_window(config) -> None:
    """Raise where the attention would need a sliding window."""
    if getattr(config, "sliding_window", None) is not None:
        raise NotImplementedError(
            f"sliding-window attention (sliding_window={config.sliding_window}) is not ported yet; "
            "set sliding_window=None to attend to the whole prefix")


class MistralAttention(LlamaAttention):
    def __init__(self, config: LlamaConfig, layer_idx: int = 0, device=None, generator=None):
        check_no_window(config)
        super().__init__(config, layer_idx, device, generator)


class MistralMLP(LlamaMLP):
    pass


class MistralDecoderLayer(LlamaDecoderLayer):
    attention_cls = MistralAttention
    mlp_cls = MistralMLP


class MistralModel(LlamaModel):
    layer_cls = MistralDecoderLayer


class MistralForCausalLM(LlamaForCausalLM):
    model_cls = MistralModel
