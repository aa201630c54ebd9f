"""The port's token-selection filters (``torchmx_tpu_torch/models/sampling.py``)
held against the JAX package's on the same seeded logits.

``filter_logits`` must keep the same set of tokens with equal values (fp32
logits pass through unchanged where kept, ``-inf`` where dropped).  Sampled
tokens are not compared: JAX's and torch's random streams differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmx_tpu.models import sampling as jsampling
from torchmx_tpu_torch.models import sampling

torch.set_num_threads(1)

FILTERS = [
    dict(top_k=5),
    dict(top_k=1),
    dict(top_p=0.8),
    dict(top_p=0.05),
    dict(min_p=0.1),
    dict(top_k=20, top_p=0.9),
    dict(top_k=20, top_p=0.9, min_p=0.05),
    dict(),
]


def seeded_logits(seed=0, shape=(4, 97), scale=3.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kw", FILTERS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "none")
def test_filter_logits_matches_jax(kw):
    x = seeded_logits()
    ref = np.asarray(jsampling.filter_logits(jnp.asarray(x), **kw))
    got = sampling.filter_logits(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_array_equal(got[~np.isneginf(got)], ref[~np.isneginf(ref)])
    assert (~np.isneginf(got)).any(axis=-1).all()  # the argmax always survives


def test_filter_logits_takes_bf16_and_leading_dims():
    x = torch.from_numpy(seeded_logits(1, (2, 3, 50))).to(torch.bfloat16)
    got = sampling.filter_logits(x, top_k=4)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert (torch.isfinite(got).sum(-1) == 4).all()


def test_greedy_is_argmax():
    x = torch.from_numpy(seeded_logits(2))
    tok = sampling.sample_logits(x, None, 0.0, top_k=3, top_p=0.5)
    assert torch.equal(tok, x.argmax(-1))
    ref = np.asarray(jsampling.sample_logits(jnp.asarray(x.numpy()), None, 0.0))
    np.testing.assert_array_equal(tok.numpy(), ref)


def test_sampling_is_reproducible_and_respects_the_filters():
    x = torch.from_numpy(seeded_logits(3, (8, 97)))
    kw = dict(top_k=6, top_p=0.9, min_p=0.02)

    def draw(seed, n=50):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sampling.sample_logits(x, g, 0.7, **kw) for _ in range(n)])

    a, b, c = draw(11), draw(11), draw(12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    allowed = torch.isfinite(sampling.filter_logits(x / 0.7, **kw))
    assert allowed.gather(-1, a.T).all()  # never a masked token
    assert (a != x.argmax(-1)).any()  # and not just the argmax
