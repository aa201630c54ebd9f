"""MX-quantized Mistral attention and MLP (``torchmx_tpu/layers/
mx_mistral_attention.py``): the Llama versions under their own types, so
that the quantization registry can target the Mistral family.  A layer
with a sliding window raises, as ``models/mistral.MistralAttention`` does."""

from __future__ import annotations

from ..models.mistral import check_no_window
from .mx_llama_attention import MXInferenceLlamaAttention, MXInferenceLlamaMLP


class MXInferenceMistralMLP(MXInferenceLlamaMLP):
    pass


class MXInferenceMistralAttention(MXInferenceLlamaAttention):
    @classmethod
    def from_float(cls, mod, qconfig):
        check_no_window(mod.config)
        return super().from_float(mod, qconfig)
