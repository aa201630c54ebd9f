"""Qwen2 (``torchmx_tpu/models/qwen2.py``): the Llama architecture with
biases on the q/k/v projections (o_proj has none).  Distinct classes, so that
the quantization registry (``quant_api``) can target them by type.

The port's attention takes no sliding window yet: a config with
``sliding_window`` set raises ``NotImplementedError`` when it is built
(``mistral.check_no_window``).  Qwen2 checkpoints carry ``sliding_window`` but
switch it off with ``use_sliding_window: false``, which
:meth:`Qwen2Config.from_hf` reads as JAX's ``from_hf`` does
(``torchmx_tpu/models/llama.py:104-114``); a ``layer_types`` in which no layer
is ``"sliding_attention"`` switches it off too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .llama import LlamaAttention, LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP, LlamaModel
from .mistral import check_no_window


@dataclasses.dataclass
class Qwen2Config(LlamaConfig):
    attention_qkv_bias: bool = True
    sliding_window: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()
        check_no_window(self)

    @classmethod
    def from_hf(cls, hf_config: Any) -> "Qwen2Config":
        """From an HF ``Qwen2Config``-like object or its ``config.json`` dict."""
        get = (lambda k, d=None: hf_config.get(k, d)) if isinstance(hf_config, dict) else (
            lambda k, d=None: getattr(hf_config, k, d))
        act = get("hidden_act") or "silu"
        if act != "silu":
            raise NotImplementedError(f"the port's MLP is SwiGLU (silu), got hidden_act={act!r}")
        return cls(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
            head_dim=get("head_dim"),
            max_position_embeddings=get("max_position_embeddings", 2048),
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            rope_theta=get("rope_theta", 10000.0),
            rope_scaling=get("rope_scaling"),
            attention_bias=bool(get("attention_bias", False)),
            mlp_bias=bool(get("mlp_bias", False)),
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            # HF semantics: with layer_types, only its "sliding_attention" layers slide.
            sliding_window=get("sliding_window") if get("use_sliding_window", True) is not False and (
                not get("layer_types") or "sliding_attention" in get("layer_types")) else None,
        )


class Qwen2Attention(LlamaAttention):
    pass


class Qwen2MLP(LlamaMLP):
    pass


class Qwen2DecoderLayer(LlamaDecoderLayer):
    attention_cls = Qwen2Attention
    mlp_cls = Qwen2MLP


class Qwen2Model(LlamaModel):
    layer_cls = Qwen2DecoderLayer


class Qwen2ForCausalLM(LlamaForCausalLM):
    model_cls = Qwen2Model
