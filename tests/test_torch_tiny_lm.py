"""The committed trained checkpoint (``artifacts/tiny_lm``) through the port:
loaded by the JAX package, converted with ``torchmx_tpu_torch.convert``,
quantized on both sides (fp4 weights, fp8 activations, fp8 KV cache); the
greedy tokens must equal JAX's (op by op, Pallas path) up to the first near
tie (JAX top-2 logit gap below 0.1).  Helpers and tolerances are those of
``test_torch_llama.py``."""

import pathlib
import sys

import numpy as np
import torch

from flax import nnx

from tests.test_torch_llama import (
    KV,
    JLlama,
    _assert_tokens_match,
    _jax_greedy,
    _quantize_pair,
    jax_backend,
)
from torchmx_tpu_torch.config import MXConfig
from torchmx_tpu_torch.models.generate import generate

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_tiny_lm_checkpoint_greedy_tokens_match_jax():
    """32 greedy tokens from two corpus prompts."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from tools.train_tiny_lm import CONFIG, load_corpus
    from torchmx_tpu import checkpoint as ckpt

    jmodel = ckpt.load_model(str(ROOT / "artifacts" / "tiny_lm"), JLlama(CONFIG, rngs=nnx.Rngs(0)))
    cfg = dict(vocab_size=CONFIG.vocab_size, hidden_size=CONFIG.hidden_size,
               intermediate_size=CONFIG.intermediate_size,
               num_hidden_layers=CONFIG.num_hidden_layers,
               num_attention_heads=CONFIG.num_attention_heads,
               num_key_value_heads=CONFIG.num_key_value_heads, head_dim=CONFIG.head_dim,
               rope_theta=CONFIG.rope_theta, rms_norm_eps=CONFIG.rms_norm_eps)
    jmodel, port = _quantize_pair(jmodel, cfg)
    corpus = load_corpus()
    ids = np.stack([corpus[i * 4099: i * 4099 + 32] for i in range(2)]).astype(np.int32)
    n = 32
    with jax_backend("pallas"):
        ref, ref_logits = _jax_greedy(jmodel, ids, n)
    got = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig(KV))
    _assert_tokens_match(ref, got.numpy(), ref_logits)
    assert (got.numpy() == ref).mean() > 0.5  # the trained model's margins are decisive
