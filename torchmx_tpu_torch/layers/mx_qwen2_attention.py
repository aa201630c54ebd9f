"""MX-quantized Qwen2 attention and MLP (``torchmx_tpu/layers/
mx_qwen2_attention.py``): the Llama versions under their own types, so that
the quantization registry can target the Qwen2 family.  The q/k/v biases
ride on the MX linears: each is added in bf16 to its projection's output,
after the shared K2 (or K1) and the matmul, as JAX adds it."""

from __future__ import annotations

from .mx_llama_attention import MXInferenceLlamaAttention, MXInferenceLlamaMLP


class MXInferenceQwen2MLP(MXInferenceLlamaMLP):
    pass


class MXInferenceQwen2Attention(MXInferenceLlamaAttention):
    pass
