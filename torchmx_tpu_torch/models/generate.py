"""Generation over an MX KV cache (``torchmx_tpu/models/generate.py``):
greedy by default, sampling with ``temperature > 0``.

Prefill writes the prompt's K/V at cache position 0 and takes the logits of
the last prompt token; each decode step appends one token.  The cache length
is the prompt plus the new tokens, rounded up to a multiple of 128 (extra
positions are masked)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import MXConfig
from .sampling import sample_logits


@torch.inference_mode()
def generate(model, input_ids: torch.Tensor, max_new_tokens: int, *,
             kv_cache_config: Optional[MXConfig], temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, min_p: float = 0.0, seed: int = 0, return_logits: bool = False):
    """``(batch, max_new_tokens)`` token ids: the argmax at ``temperature ==
    0``, else sampled through the temperature / top-k / top-p / min-p filters
    from a generator seeded with ``seed`` on the model's device.  With
    ``return_logits`` also the fp32 logits ``(batch, max_new_tokens, vocab)``
    each token was picked from.  ``kv_cache_config`` None asks the model
    for its high-precision cache (DeepSeek-V3's bf16 ``MLACache``; Llama's
    bf16 cache is not ported and raises)."""
    input_ids = input_ids.to(model.device)
    b, s = input_ids.shape
    max_len = (s + max_new_tokens + 127) // 128 * 128
    caches = model.init_cache(b, max_len, kv_cache_config)
    generator = None
    if temperature != 0.0:
        generator = torch.Generator(model.device).manual_seed(seed)

    def pick(logits):
        return sample_logits(logits, generator, temperature, top_k=top_k, top_p=top_p, min_p=min_p)

    tokens, all_logits = [], []
    for i in range(max_new_tokens):
        if i == 0:
            logits = model(input_ids, caches=caches, cache_position=0, last_only=True)[:, -1]
        else:
            logits = model(tokens[-1][:, None], caches=caches, cache_position=s + i - 1)[:, -1]
        tokens.append(pick(logits))
        if return_logits:
            all_logits.append(logits.float())
    out = torch.stack(tokens, dim=1)
    return (out, torch.stack(all_logits, dim=1)) if return_logits else out
