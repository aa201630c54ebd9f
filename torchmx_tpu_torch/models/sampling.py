"""Token-selection filters shared by ``generate()`` and ``DecodeEngine``
(``torchmx_tpu/models/sampling.py``): the HF-warper stack, temperature ->
top-k -> top-p (nucleus) -> min-p, vectorized over the batch.  Greedy
selection stays a plain ``argmax``.

Sampling draws from an explicit ``torch.Generator`` on the logits' device.
Its stream is not JAX's: from the same seed the two packages sample different
tokens from the same distribution.
"""

from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, *, top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """Mask (to ``-inf``) the logits excluded by top-k / top-p / min-p.

    ``logits`` are ``(..., V)`` unnormalized (already temperature-scaled);
    the result is fp32.  ``top_k``: keep the k highest (0 = no restriction).
    ``top_p``: keep the smallest set whose cumulative probability reaches
    ``top_p`` (1.0 = no restriction); the argmax always survives.  ``min_p``:
    drop tokens whose probability is below ``min_p`` times the maximum
    (0.0 = no restriction).  The filters compose in the HF order, each over
    the distribution the previous one left."""
    v = logits.shape[-1]
    x = logits.to(torch.float32)
    neg = float("-inf")
    if 0 < top_k < v:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, neg, x)
    if top_p < 1.0:
        probs = torch.softmax(x, dim=-1)
        desc = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(desc, dim=-1)
        # Keep while the mass before a token is < top_p: the token that
        # crosses the threshold is included.
        kept = torch.where(csum - desc < top_p, desc, float("inf"))
        thresh = kept.amin(dim=-1, keepdim=True)
        x = torch.where(probs < thresh, neg, x)
    if min_p > 0.0:
        probs = torch.softmax(x, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        x = torch.where(probs < min_p * pmax, neg, x)
    return x


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator], temperature: float, *,
                  top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0) -> torch.Tensor:
    """One token id per row of ``(..., V)`` logits: greedy at
    ``temperature == 0``, else a draw from the filtered, temperature-scaled
    distribution with ``generator`` (on the logits' device).  Returns int64
    ``(...,)``."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    scaled = filter_logits(logits.to(torch.float32) / temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    probs = torch.softmax(scaled, dim=-1)
    flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return flat.reshape(probs.shape[:-1])
