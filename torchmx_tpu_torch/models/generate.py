"""Greedy generation over an MX KV cache (``torchmx_tpu/models/generate.py``).

Prefill writes the prompt's K/V at cache position 0 and takes the logits of
the last prompt token; each decode step appends one token.  The cache length
is the prompt plus the new tokens, rounded up to a multiple of 128 (extra
positions are masked)."""

from __future__ import annotations

import torch

from ..config import MXConfig


@torch.inference_mode()
def generate(model, input_ids: torch.Tensor, max_new_tokens: int, *,
             kv_cache_config: MXConfig, return_logits: bool = False):
    """Greedy ``(batch, max_new_tokens)`` token ids; with ``return_logits``
    also the fp32 logits ``(batch, max_new_tokens, vocab)`` each token was
    picked from."""
    if kv_cache_config is None:
        raise NotImplementedError("a bf16 KV cache is not ported; pass an MX kv_cache_config")
    input_ids = input_ids.to(model.device)
    b, s = input_ids.shape
    max_len = (s + max_new_tokens + 127) // 128 * 128
    caches = model.init_cache(b, max_len, kv_cache_config)
    logits = model(input_ids, caches=caches, cache_position=0, last_only=True)[:, -1]
    tokens, all_logits = [logits.argmax(dim=-1)], [logits.float()]
    for i in range(max_new_tokens - 1):
        logits = model(tokens[-1][:, None], caches=caches, cache_position=s + i)[:, -1]
        tokens.append(logits.argmax(dim=-1))
        if return_logits:
            all_logits.append(logits.float())
    out = torch.stack(tokens, dim=1)
    return (out, torch.stack(all_logits, dim=1)) if return_logits else out
