"""The port's Qwen2 (q/k/v biases, GQA groups of 7, head_dim 64) held against
the JAX package on the same weights.

Weights come from the JAX model (seeded ``nnx.Rngs``, the q/k/v biases set
nonzero from a numpy seed, the k bias larger than q's and v's as in the
published checkpoints) through ``torchmx_tpu_torch.convert``; both sides
quantize them with their own ``quantize_llm_`` (fp4 weights, fp8
activations).  The JAX side runs its Pallas path in interpret mode.
Tolerances are those of ``tests/test_torch_llama.py``: logits rel <= 2e-2
(max abs difference over max abs logit; against JAX's eager route the port
may be 2e-2 farther than JAX's kernel path is), greedy tokens equal up to
the first near tie (top-2 gap below 0.1); the plain K5 and K7 at groups of
3, 5, 6 and 7 equal JAX's kernels bit for bit where groups 1, 2, 4 and 8 do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from tests.test_torch_kernels import _cache_tensors, _mx_cache, bits, rand_bf16, to_torch
from tests.test_torch_llama import (
    REL_TOL,
    _assert_tokens_match,
    _flat,
    _jax_greedy,
    _jax_steps,
    _port_steps,
    _rel,
    jax_backend,
    kv_layout,
)
from torchmx_tpu.config import MXConfig as JMXConfig
from torchmx_tpu.config import QAttentionConfig as JQAttn
from torchmx_tpu.config import QLinearConfig as JQLin
from torchmx_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from torchmx_tpu.models.qwen2 import Qwen2ForCausalLM as JQwen2
from torchmx_tpu.ops import fallbacks as jfallbacks
from torchmx_tpu.ops import pallas_attention as jpa
from torchmx_tpu.quant_api import quantize_llm_ as jquantize_llm_
from torchmx_tpu_torch import convert
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.models.generate import generate
from torchmx_tpu_torch.models.qwen2 import Qwen2Config, Qwen2ForCausalLM
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import fallbacks
from torchmx_tpu_torch.quant_api import quantize_llm_

torch.set_num_threads(1)

# 7 query heads over 1 KV head at head_dim 128 (Qwen2-7B's group), and at
# head_dim 64 (Qwen2-0.5B's, where JAX's plan has no attention kernel) with
# tied embeddings.
G7 = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
          num_attention_heads=7, num_key_value_heads=1, head_dim=128)
D64 = dict(vocab_size=256, hidden_size=448, intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=7, num_key_value_heads=1, head_dim=64, tie_word_embeddings=True)
MAX_LEN = 256


def _set_biases(jmodel, seed: int) -> None:
    """Nonzero q/k/v biases from a numpy seed: k's 1.0 std, q's and v's 0.1."""
    rng = np.random.default_rng(seed)
    for layer in jmodel.model.layers:
        attn = layer.self_attn
        for name, std in (("q_proj", 0.1), ("k_proj", 1.0), ("v_proj", 0.1)):
            bias = getattr(attn, name).bias
            bias.set_value(jnp.asarray(rng.standard_normal(bias.get_value().shape) * std, jnp.bfloat16))


def _qwen2_pair(cfg: dict, seed: int = 0):
    """(quantized JAX Qwen2, quantized port Qwen2) from the same bf16 weights."""
    jmodel = JQwen2(JQwen2Config(**cfg), rngs=nnx.Rngs(seed))
    _set_biases(jmodel, seed + 100)
    port = convert.from_flat_params(_flat(jmodel), Qwen2Config(**cfg), device="cpu")
    jq = JQLin(weights_config=JMXConfig("float4_e2m1"), activations_config=JMXConfig("float8_e4m3"))
    jquantize_llm_(jmodel, JQAttn(projection_config=jq), jq)
    tq = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    quantize_llm_(port, QAttentionConfig(tq), tq)
    return jmodel, port


@pytest.fixture(scope="module")
def g7_pair():
    return _qwen2_pair(G7)


@pytest.fixture(scope="module")
def d64_pair():
    return _qwen2_pair(D64, seed=1)


def _attention_counts(counts: dict) -> dict:
    """The counts of the attention's eager route (JAX also counts other ops)."""
    return {k: v for k, v in counts.items() if k.startswith("cached_attention: ")}


def _ids(seed, b, s, n_forced=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(b, s)).astype(np.int32),
            rng.integers(0, 256, size=(b, n_forced)).astype(np.int32))


# -- the model: registry, biases, conversion ----------------------------------------------------


def test_registry_picks_the_qwen2_classes_and_o_proj_has_no_bias(g7_pair):
    _, port = g7_pair
    layer = port.model.layers[0]
    assert type(layer.self_attn).__name__ == "MXInferenceQwen2Attention"
    assert type(layer.mlp).__name__ == "MXInferenceQwen2MLP"
    attn = layer.self_attn
    assert all(getattr(attn, n).bias is not None for n in ("q_proj", "k_proj", "v_proj"))
    assert attn.o_proj.bias is None
    assert float(attn.k_proj.bias.float().abs().mean()) > 3 * float(attn.q_proj.bias.float().abs().mean()) > 0
    assert convert.causal_lm_class(Qwen2Config(**G7)) is Qwen2ForCausalLM


def test_conversion_refuses_an_o_proj_bias():
    """JAX's Qwen2 has no o_proj bias; a state that holds one is refused."""
    jmodel = JQwen2(JQwen2Config(**dict(G7, num_hidden_layers=1)), rngs=nnx.Rngs(3))
    params = _flat(jmodel)
    params["model.layers.0.self_attn.o_proj.bias"] = np.zeros(G7["hidden_size"], np.float32)
    with pytest.raises(KeyError, match="o_proj.bias"):
        convert.from_flat_params(params, Qwen2Config(**dict(G7, num_hidden_layers=1)), device="cpu")


def test_from_hf_reads_use_sliding_window_and_a_window_raises():
    """Qwen2-7B's published config.json (the fields read): the window it
    carries is switched off by ``use_sliding_window``; a config that would
    slide raises when it is built."""
    hf = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
              num_attention_heads=28, num_key_value_heads=4, max_position_embeddings=131072,
              rms_norm_eps=1e-6, rope_theta=1000000.0, sliding_window=131072, use_sliding_window=False,
              max_window_layers=28, tie_word_embeddings=False, hidden_act="silu")
    cfg = Qwen2Config.from_hf(hf)
    jcfg = JQwen2Config.from_hf(hf)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "rms_norm_eps", "rope_theta", "tie_word_embeddings",
              "attention_qkv_bias", "attention_bias", "sliding_window"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.head_dim == 128 and cfg.attention_qkv_bias and cfg.sliding_window is None
    with pytest.raises(NotImplementedError, match="sliding"):
        Qwen2Config.from_hf(dict(hf, use_sliding_window=True))
    full = dict(hf, use_sliding_window=True, layer_types=["full_attention"] * 28)  # no layer slides
    assert Qwen2Config.from_hf(full).sliding_window is None
    assert all(JQwen2Config.from_hf(full).layer_window(i) is None for i in range(28))
    with pytest.raises(NotImplementedError, match="sliding"):
        Qwen2Config.from_hf(dict(full, layer_types=["full_attention"] * 27 + ["sliding_attention"]))


# -- logits at a group of 7 over the three decode routes ------------------------------------------


G7_CACHES = {"fp8 seq": ("float8_e4m3", "seq", "0"), "int8 seq (K5)": ("int8", "seq", "0"),
             "int8 dmajor int8dot (K7)": ("int8", "dmajor", "1")}


@pytest.fixture(scope="module")
def g7_logits(g7_pair):
    """Prefill of 8 tokens and 3 teacher-forced decode steps, the rows at
    their own positions (row 1 rewinds to 5): (JAX Pallas, port) logits per
    cache, each computed once."""
    jmodel, port = g7_pair
    ids, forced = _ids(4, 2, 8)
    row_pos = np.array([8, 5], np.int32)
    done = {}

    def logits(name):
        if name not in done:
            kv, layout, flag = G7_CACHES[name]
            with kv_layout(layout, flag), jax_backend("pallas"):
                ref = _jax_steps(jmodel, ids, forced, MAX_LEN, kv, row_pos)
                done[name] = ref, _port_steps(port, ids, forced, MAX_LEN, kv, row_pos)
        return done[name]

    return logits


@pytest.mark.parametrize("step", [0, 1, 2, 3], ids=["prefill", "decode1", "decode2", "decode3"])
@pytest.mark.parametrize("cache", list(G7_CACHES))
def test_group7_logits_match_jax(g7_logits, cache, step):
    ref, got = g7_logits(cache)
    rel = _rel(got[:, step], ref[:, step])
    print(f"group 7, {cache} cache, step {step}: rel {rel:.3e}")
    assert rel <= REL_TOL


def test_group7_decode_takes_k5_and_k7(g7_pair, monkeypatch):
    """The port's dispatch sends a group of 7 to K5 (int8 seq) and K7 (int8
    d-major with the all-int8 flag) at decode, as JAX's does."""
    _, port = g7_pair
    calls = []
    for name in ("mx_cached_attention_chunkdot", "mx_cached_attention_int8dot", "mx_cached_attention",
                 "mx_cached_attention_dmajor"):
        real = getattr(ca, name)
        monkeypatch.setattr(ca, name, lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    ids, forced = _ids(5, 1, 8, 1)
    for kv, layout, flag in G7_CACHES.values():
        calls.clear()
        with kv_layout(layout, flag):
            _port_steps(port, ids, forced, MAX_LEN, kv)
        want = {"float8_e4m3": "mx_cached_attention", "int8": "mx_cached_attention_chunkdot"}[kv]
        if layout == "dmajor":
            want = "mx_cached_attention_int8dot"
        assert calls[2:] == [want] * 2, calls  # the two layers' decode step, after the prefill


def test_group7_greedy_generate_matches_jax(g7_pair):
    jmodel, port = g7_pair
    ids = np.random.default_rng(6).integers(0, 256, size=(2, 8)).astype(np.int32)
    n = 12
    with jax_backend("pallas"):
        ref, ref_logits = _jax_greedy(jmodel, ids, n, max_len=MAX_LEN, kv="int8")
    got = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig("int8"))
    _assert_tokens_match(ref, got.numpy(), ref_logits)


def test_group7_prompt_without_a_jax_query_tile(g7_pair, monkeypatch):
    """A prompt of 37 tokens at a group of 7: JAX's plan finds no query tile
    (``_pick_sqt``), so JAX's prefill takes its eager route and counts it;
    the port keeps K4 (counting nothing), as it does at every length.  Its
    logits are JAX's kernel path's (the JAX kernel run at that length with
    the whole prompt as its query tile) within 2e-2, and JAX's own route's
    under the eager rule of ``test_torch_llama``: within 2e-2 plus the
    distance between JAX's two paths."""
    jmodel, port = g7_pair
    assert jpa._pick_sqt(37, 7) is None and jpa._pick_sqt(40, 7) is not None
    ids, forced = _ids(7, 2, 37, 2)
    jfallbacks.reset_fallback_counts()
    with jax_backend("pallas"):
        jax_route = _jax_steps(jmodel, ids, forced, MAX_LEN, "int8")
    assert _attention_counts(jfallbacks.fallback_counts()) == {  # the prefill's layers
        "cached_attention: q(2, 7, 37, 128) cache(2, 1, 256, 128) int8": G7["num_hidden_layers"]}
    pick_sqt = jpa._pick_sqt
    monkeypatch.setattr(jpa, "_pick_sqt", lambda sq, g: pick_sqt(sq, g) or sq)
    jfallbacks.reset_fallback_counts()
    with jax_backend("pallas"):
        jax_kernel = _jax_steps(jmodel, ids, forced, MAX_LEN, "int8")
    assert _attention_counts(jfallbacks.fallback_counts()) == {}
    fallbacks.reset_fallback_counts()
    got = _port_steps(port, ids, forced, MAX_LEN, "int8")
    assert fallbacks.fallback_counts() == {}
    for step in range(got.shape[1]):
        rel_kernel, rel_route = _rel(got[:, step], jax_kernel[:, step]), _rel(got[:, step], jax_route[:, step])
        allowed = REL_TOL + _rel(jax_kernel[:, step], jax_route[:, step])
        print(f"sq=37 step {step}: rel {rel_kernel:.3e} to JAX's kernel, {rel_route:.3e} to JAX's route "
              f"(allowed {allowed:.3e})")
        assert rel_kernel <= REL_TOL and rel_route <= allowed


# -- head_dim 64: JAX's counted eager route ---------------------------------------------------------


def test_d64_logits_and_fallback_counts_match_jax(d64_pair):
    """No attention kernel in either package's plan at head_dim 64: both run
    the eager route over the dequantized int8 cache, each call counted under
    the same key; the logits (tied lm_head) within 2e-2."""
    jmodel, port = d64_pair
    ids, forced = _ids(8, 2, 8)
    row_pos = np.array([8, 6], np.int32)
    assert jpa.plan_cached_attention(7, 1, 1, MAX_LEN, 64, "int8") is None
    jfallbacks.reset_fallback_counts()
    with jax_backend("pallas"):
        ref = _jax_steps(jmodel, ids, forced, MAX_LEN, "int8", row_pos)
    jcounts = _attention_counts(jfallbacks.fallback_counts())
    fallbacks.reset_fallback_counts()
    got = _port_steps(port, ids, forced, MAX_LEN, "int8", row_pos)
    assert fallbacks.fallback_counts() == jcounts
    assert sum(jcounts.values()) == D64["num_hidden_layers"] * (1 + forced.shape[1])
    for step in range(got.shape[1]):
        rel = _rel(got[:, step], ref[:, step])
        print(f"head_dim 64 step {step}: rel {rel:.3e}")
        assert rel <= REL_TOL


def test_d64_tied_greedy_generate_matches_jax(d64_pair):
    """Greedy tokens of the tied-embedding model at head_dim 64 against JAX
    op by op; the port's lm_head is the embedding product."""
    jmodel, port = d64_pair
    assert port.lm_head is None and jmodel.lm_head is None
    ids = np.random.default_rng(9).integers(0, 256, size=(2, 8)).astype(np.int32)
    n = 12
    with jax_backend("pallas"):
        ref, ref_logits = _jax_greedy(jmodel, ids, n, max_len=MAX_LEN, kv="int8")
    fallbacks.reset_fallback_counts()
    got = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig("int8"))
    _assert_tokens_match(ref, got.numpy(), ref_logits)
    assert sum(fallbacks.fallback_counts().values()) == D64["num_hidden_layers"] * n


def test_tied_logits_match_jax_bf16_product(d64_pair):
    """The tied lm_head: the port's fp32 product rounded once to bf16 against
    JAX's bf16 ``hidden @ embed.T``."""
    jmodel, port = d64_pair
    h = rand_bf16(10, (3, D64["hidden_size"]), spread=1.0)
    ref = np.asarray(jnp.asarray(h, jnp.bfloat16) @ jmodel.model.embed_tokens.weight.get_value().T, np.float32)
    got = port.logits(to_torch(h)).float().numpy()
    assert _rel(got, ref) <= REL_TOL
    print(f"tied lm_head: {int((got != ref).sum())} of {got.size} logits differ from JAX's")


def test_dispatch_has_no_kernel_exactly_where_jax_has_none():
    """``cached_attention_any`` returns None exactly where JAX's plan rejects
    the head_dim (any layout, any format)."""
    from torchmx_tpu_torch.models.llama import MXLayerKVCache

    for d in (64, 128, 192, 256):
        for layout, kv in (("seq", "int8"), ("seq", "float8_e4m3"), ("dmajor", "int8")):
            cache = MXLayerKVCache.create(1, 1, 128, d, kv, device="cpu", layout=layout)
            q = torch.zeros(1, 7, 1, d, dtype=torch.bfloat16)
            out = ca.cached_attention_any(q, cache, 0, 1, d ** -0.5)
            assert (out is None) == (jpa.plan_cached_attention(7, 1, 1, 128, d, kv) is None) == (d % 128 != 0)


@pytest.mark.parametrize("sq", [1, 24])
def test_eager_route_in_float64_is_its_other_rounding(sq):
    """The eager route with ``compute_dtype=torch.float64`` (the model
    check's float64 floor at head_dim 64) computes the same function: within
    the bf16 roundings of scores and p of the route itself, and not equal to
    it."""
    from torchmx_tpu_torch.models.llama import MXLayerKVCache

    cache = MXLayerKVCache.create(2, 2, 128, 64, "int8", device="cpu")
    cache.write(to_torch(rand_bf16(23, (2, 2, 40, 64), 0.0)), to_torch(rand_bf16(24, (2, 2, 40, 64), 0.0)), 0)
    q = to_torch(rand_bf16(25, (2, 14, sq, 64), 0.0))
    q_off = 40 - sq
    got, f64 = ca.cached_attention_eager(q, cache, q_off), ca.cached_attention_eager(q, cache, q_off, torch.float64)
    assert f64.dtype == got.dtype == torch.bfloat16 and f64.shape == got.shape
    assert 0 < _rel(got.float().numpy(), f64.float().numpy()) <= 2e-2


# -- the plain K5 and K7 at every group --------------------------------------------------------------


@pytest.mark.parametrize("G", [3, 5, 6, 7])
def test_chunkdot_plain_matches_pallas_kernel_at_group(G):
    """K5's plain version against the JAX chunk-dot kernel at a group of G (2
    KV heads, L = 256: JAX's one tile), bit for bit, as at groups 1-8."""
    from tests.test_torch_kernels import jenv

    old = jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
    try:
        b, hkv, d, L = 3, 2, 128, 256
        cache = _mx_cache(11, b, hkv, L, d, "int8")
        q = rand_bf16(12 + G, (b, G * hkv, 1, d), spread=0.5)
        q_off, kv_len = np.array([0, 130, 255], np.int32), np.array([1, 100, 256], np.int32)
        ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), cache, jnp.asarray(q_off),
                                       jnp.asarray(kv_len), d ** -0.5)
    finally:
        jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = old
    got = ca.mx_cached_attention_chunkdot_plain(to_torch(q), *_cache_tensors(cache), torch.from_numpy(q_off),
                                                torch.from_numpy(kv_len), d ** -0.5)
    assert np.array_equal(bits(got), bits(ref))
    assert ca.use_chunkdot("int8", 1, d, G, L) and jpa.use_chunkdot("int8", 1, d)


@pytest.mark.parametrize("L", [256, 1024])
@pytest.mark.parametrize("G", [3, 5, 6, 7])
def test_int8dot_plain_matches_pallas_kernel_at_group(G, L):
    """K7's plain version against JAX's all-int8 kernel at a group of G (2 KV
    heads; L = 1024 is two of JAX's tiles): bit for bit but for fp32
    summation order in rare elements, as at groups 1-8 (over four draws of
    these shapes one element in 4608 differs at G = 6 and at G = 8, by one
    bf16 step): at most 0.1 % of the elements, each within one bf16 step of
    its row's largest."""
    from tests.test_torch_dmajor import filled_caches
    from tests.test_torch_kernels import jenv
    from torchmx_tpu_torch import env_variables as tenv

    d, b, hkv = 128, 3, 2
    jc, tc = filled_caches(31 + G, b, hkv, L, d, "int8")
    q = rand_bf16(40 + G, (b, G * hkv, 1, d), spread=0.5)
    q_off, kv_len = np.array([0, L // 2 + 5, L - 1], np.int32), np.array([1, L // 2 - 20, L], np.int32)
    old = (jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION, jenv.TORCHMX_ATTN_INT8_DOT,
           tenv.TORCHMX_ATTN_INT8_DOT)
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
    jenv.TORCHMX_ATTN_INT8_DOT = tenv.TORCHMX_ATTN_INT8_DOT = "1"
    try:
        assert jpa.use_int8dot(jc, 1, d) and ca.use_int8dot(tc, 1, d, G)
        ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), jc, jnp.asarray(q_off), jnp.asarray(kv_len),
                                       d ** -0.5)
        via = ca.cached_attention_any(to_torch(q), tc, torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5)
    finally:
        (jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION, jenv.TORCHMX_ATTN_INT8_DOT,
         tenv.TORCHMX_ATTN_INT8_DOT) = old
    got = ca.mx_cached_attention_int8dot_plain(to_torch(q), *tc.buffers, torch.from_numpy(q_off),
                                               torch.from_numpy(kv_len), d ** -0.5)
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    assert (g != r).mean() <= 1e-3
    assert (np.abs(g - r) <= 2.0 ** -7 * np.abs(r).max(axis=-1, keepdims=True)).all()
    assert torch.equal(via, got)
