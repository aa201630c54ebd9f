"""The port's slice as a whole: an MXFP4-weight / MXFP8-activation Llama with
an fp8 or int8 KV cache, held against the JAX package on the same weights.

Weights come from the JAX model (seeded ``nnx.Rngs``) through
``torchmx_tpu_torch.convert``; both sides quantize them with their own
``quantize_llm_``.  The port's attention follows the fused kernel (fp32
scores, online softmax), so its reference is the JAX Pallas path, run in
interpret mode.  Tolerances:

* logits against the Pallas path: rel <= 2e-2 (max abs difference over max
  abs logit);
* logits against the eager jnp path: the JAX package's two paths themselves
  differ here (bf16 scores and full softmax in the eager path; activation
  fake-quantization amplifies each ulp into a quantization step), so the
  port may be at most 2e-2 farther from the eager path than the Pallas path
  is;
* greedy tokens equal to JAX greedy decoding on the Pallas path up to the
  first step where JAX's top-2 logit gap is below 0.1 (a near tie that a
  1-ulp difference may flip; the test prints the gap).  The JAX decode runs
  op by op: under ``jit`` (``torchmx_tpu.models.generate``) XLA drops
  intermediate bf16 roundings, so JAX's jitted ``generate`` differs from its
  own op-by-op steps by more than a near tie; the port follows the op-by-op
  arithmetic, which is the one written in the source.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from torchmx_tpu import env_variables as jenv
from torchmx_tpu_torch import env_variables as tenv
from torchmx_tpu.config import MXConfig as JMXConfig
from torchmx_tpu.config import QAttentionConfig as JQAttn
from torchmx_tpu.config import QLinearConfig as JQLin
from torchmx_tpu.models.llama import LlamaConfig as JLlamaConfig
from torchmx_tpu.models.llama import LlamaForCausalLM as JLlama
from torchmx_tpu.quant_api import quantize_llm_ as jquantize_llm_
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.convert import from_flat_params
from torchmx_tpu_torch.models.generate import generate
from torchmx_tpu_torch.models.llama import LlamaConfig
from torchmx_tpu_torch.quant_api import quantize_llm_

torch.set_num_threads(1)

SMALL = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=128)
KV = "float8_e4m3"
REL_TOL = 2e-2
TIE_GAP = 0.1


def _flat(jmodel) -> dict:
    _, state = nnx.split(jmodel)
    return {".".join(map(str, k)): np.asarray(v.get_value()) for k, v in state.flat_state()}


def _quantize_pair(jmodel, cfg_kwargs):
    """(quantized JAX model, quantized port model) from the same bf16 weights."""
    port = from_flat_params(_flat(jmodel), LlamaConfig(**cfg_kwargs), device="cpu")
    jq = JQLin(weights_config=JMXConfig("float4_e2m1"), activations_config=JMXConfig("float8_e4m3"))
    jquantize_llm_(jmodel, JQAttn(projection_config=jq), jq)
    tq = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    quantize_llm_(port, QAttentionConfig(tq), tq)
    return jmodel, port


@contextlib.contextmanager
def jax_backend(mode: str):
    """``eager``: the jnp path (dequantized cache); ``pallas``: the Pallas
    kernels in interpret mode."""
    old = jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION
    if mode == "pallas":
        jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
    else:
        jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "jnp", "off"
    try:
        yield
    finally:
        jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = old


@contextlib.contextmanager
def kv_layout(layout: str, int8dot: str = "0"):
    """The KV-cache layout and the all-int8 decode flag, set on both
    packages' env modules."""
    old = jenv.TORCHMX_KV_LAYOUT, jenv.TORCHMX_ATTN_INT8_DOT, tenv.TORCHMX_KV_LAYOUT, tenv.TORCHMX_ATTN_INT8_DOT
    jenv.TORCHMX_KV_LAYOUT = tenv.TORCHMX_KV_LAYOUT = layout
    jenv.TORCHMX_ATTN_INT8_DOT = tenv.TORCHMX_ATTN_INT8_DOT = int8dot
    try:
        yield
    finally:
        jenv.TORCHMX_KV_LAYOUT, jenv.TORCHMX_ATTN_INT8_DOT, tenv.TORCHMX_KV_LAYOUT, tenv.TORCHMX_ATTN_INT8_DOT = old


def _jax_steps(jmodel, ids: np.ndarray, forced: np.ndarray, max_len: int, kv: str = KV, row_pos=None):
    """JAX logits (b, 1 + len(forced), V) fp32: prefill, then decode steps
    teacher-forced on ``forced`` tokens.  ``row_pos`` (b,) starts each row's
    decode at its own position (per-row ``cache_position``)."""
    b, s = ids.shape
    caches = jmodel.init_cache(b, max_len, JMXConfig(kv))
    logits, caches = jmodel(jnp.asarray(ids), attention_mask=None,
                            position_ids=jnp.arange(s)[None, :], caches=caches, cache_position=0)
    out = [np.asarray(logits[:, -1], np.float32)]
    for i in range(forced.shape[1]):
        if row_pos is None:
            position_ids, pos = jnp.full((b, 1), s + i, jnp.int32), s + i
        else:
            pos = jnp.asarray(row_pos + i, jnp.int32)
            position_ids = pos[:, None]
        logits, caches = jmodel(jnp.asarray(forced[:, i:i + 1]), attention_mask=None,
                                position_ids=position_ids, caches=caches, cache_position=pos)
        out.append(np.asarray(logits[:, -1], np.float32))
    return np.stack(out, axis=1)


def _jax_greedy(jmodel, ids: np.ndarray, n: int, max_len: int = 128, kv: str = KV):
    """JAX greedy decoding, op by op: (tokens (b, n), logits (b, n, V))."""
    b, s = ids.shape
    caches = jmodel.init_cache(b, max_len, JMXConfig(kv))
    logits, caches = jmodel(jnp.asarray(ids), attention_mask=None,
                            position_ids=jnp.arange(s)[None, :], caches=caches, cache_position=0)
    steps = [np.asarray(logits[:, -1], np.float32)]
    for i in range(n - 1):
        tok = jnp.asarray(steps[-1].argmax(-1)[:, None], jnp.int32)
        logits, caches = jmodel(tok, attention_mask=None,
                                position_ids=jnp.full((b, 1), s + i, jnp.int32),
                                caches=caches, cache_position=s + i)
        steps.append(np.asarray(logits[:, -1], np.float32))
    logits = np.stack(steps, axis=1)
    return logits.argmax(-1), logits


def _port_steps(port, ids: np.ndarray, forced: np.ndarray, max_len: int, kv: str = KV, row_pos=None):
    b, s = ids.shape
    caches = port.init_cache(b, max_len, MXConfig(kv))
    with torch.inference_mode():
        out = [port(torch.from_numpy(ids), caches=caches, cache_position=0)[:, -1].float()]
        for i in range(forced.shape[1]):
            tok = torch.from_numpy(forced[:, i:i + 1])
            pos = s + i if row_pos is None else torch.from_numpy(row_pos + i)
            out.append(port(tok, caches=caches, cache_position=pos)[:, -1].float())
    return torch.stack(out, dim=1).numpy()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _assert_tokens_match(ref_tokens, got_tokens, ref_logits):
    """Equal up to the first near tie of the reference (gap < TIE_GAP)."""
    for row in range(ref_tokens.shape[0]):
        for i, (r, g) in enumerate(zip(ref_tokens[row], got_tokens[row])):
            top2 = np.sort(ref_logits[row, i])[-2:]
            gap = float(top2[1] - top2[0])
            if r != g:
                print(f"row {row} step {i}: tokens {r} vs {g}, JAX top-2 gap {gap:.4f}")
                assert gap < TIE_GAP, f"tokens differ at row {row} step {i} with gap {gap}"
                break


@pytest.fixture(scope="module")
def small_pair():
    jmodel = JLlama(JLlamaConfig(**SMALL), rngs=nnx.Rngs(0))
    return _quantize_pair(jmodel, SMALL)


@pytest.fixture(scope="module")
def small_logits(small_pair):
    """Prefill + 3 teacher-forced decode steps: (eager, pallas, port) logits."""
    jmodel, port = small_pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    forced = rng.integers(0, SMALL["vocab_size"], size=(2, 3)).astype(np.int32)
    out = {}
    for mode in ("eager", "pallas"):
        with jax_backend(mode):
            out[mode] = _jax_steps(jmodel, ids, forced, 128)
    out["port"] = _port_steps(port, ids, forced, 128)
    return out


@pytest.mark.parametrize("mode", ["eager", "pallas"])
def test_prefill_and_decode_logits_match_jax(small_logits, mode):
    ref, got = small_logits[mode], small_logits["port"]
    for step in range(ref.shape[1]):
        rel = _rel(got[:, step], ref[:, step])
        allowed = REL_TOL
        if mode == "eager":
            allowed += _rel(small_logits["pallas"][:, step], ref[:, step])
        print(f"{mode} step {step}: rel {rel:.3e} (allowed {allowed:.3e})")
        assert rel <= allowed


def test_greedy_generate_matches_jax(small_pair):
    jmodel, port = small_pair
    ids = np.random.default_rng(1).integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    n = 16
    with jax_backend("pallas"):
        ref, ref_logits = _jax_greedy(jmodel, ids, n)
    got, got_logits = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig(KV),
                               return_logits=True)
    assert got_logits.shape == (2, n, SMALL["vocab_size"])
    _assert_tokens_match(ref, got.numpy(), ref_logits)


# -- per-row cache positions and the int8 cache ----------------------------------


@pytest.mark.parametrize("kv", ["int8", "float8_e4m3"])
def test_per_row_cache_write_matches_jax_bit_for_bit(kv):
    """``MXLayerKVCache.write`` with (b,) positions against the JAX cache's:
    codes and scales bit-exact, including a start that runs past the buffer
    and is clamped (row 2 writes 3 positions at 30 into a cache of 32, row 3
    one position at ``max_len``)."""
    from torchmx_tpu.models.llama import MXLayerKVCache as JCache
    from torchmx_tpu_torch.models.llama import MXLayerKVCache

    b, h, L, d = 4, 2, 32, 64
    rng = np.random.default_rng(7)
    jc, tc = JCache.create(b, h, L, d, kv, 32, layout="seq"), MXLayerKVCache.create(b, h, L, d, kv, device="cpu")
    for s_len, pos in ((5, [0, 3, 27, 11]), (3, [5, 0, 30, 29]), (1, [8, 31, 4, 32]), (1, [9, 2, 40, 0])):
        k = np.asarray(jnp.asarray(rng.standard_normal((b, h, s_len, d)), jnp.bfloat16), np.float32)
        v = np.asarray(jnp.asarray(rng.standard_normal((b, h, s_len, d)) * 8, jnp.bfloat16), np.float32)
        jc = jc.write(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos, jnp.int32))
        tc.write(torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16),
                 torch.tensor(pos, dtype=torch.int32))
        for name in ("k_data", "k_scale", "v_data", "v_scale"):
            np.testing.assert_array_equal(getattr(tc, name).numpy().view(np.uint8),
                                          np.asarray(getattr(jc, name)).view(np.uint8), err_msg=name)
    with pytest.raises(ValueError, match="per-row positions"):
        tc.write(torch.zeros(b, h, 1, d), torch.zeros(b, h, 1, d), torch.zeros(b + 1, dtype=torch.int32))


def test_int_and_per_row_positions_agree(small_pair):
    """A (b,) position tensor with equal entries computes what the int does."""
    _, port = small_pair
    rng = np.random.default_rng(3)
    ids = rng.integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    forced = rng.integers(0, SMALL["vocab_size"], size=(2, 2)).astype(np.int32)
    for kv in ("int8", KV):
        a = _port_steps(port, ids, forced, 128, kv)
        b = _port_steps(port, ids, forced, 128, kv, row_pos=np.array([8, 8], np.int32))
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def small_logits_int8(small_pair):
    """int8 cache: prefill of 8 tokens, then 3 teacher-forced decode steps
    with the rows at their own positions (row 0 goes on at 8, row 1 rewinds
    to 5 and overwrites from there): a function of (layout, all-int8 flag)
    giving (pallas, port) logits, each pair computed once."""
    jmodel, port = small_pair
    rng = np.random.default_rng(4)
    ids = rng.integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    forced = rng.integers(0, SMALL["vocab_size"], size=(2, 3)).astype(np.int32)
    row_pos = np.array([8, 5], np.int32)
    done = {}

    def logits(layout, int8dot):
        if (layout, int8dot) not in done:
            with kv_layout(layout, int8dot), jax_backend("pallas"):
                ref = _jax_steps(jmodel, ids, forced, 128, "int8", row_pos)
                done[layout, int8dot] = ref, _port_steps(port, ids, forced, 128, "int8", row_pos)
        return done[layout, int8dot]

    return logits


# The d-major cache with the flag off computes what the seq cache computes
# (the int8 seq tolerance holds).  With the flag on, decode goes through the
# all-int8 kernel in both packages; at max_len 128 both take the cache as one
# tile of 128 positions, so the port's plain version repeats the JAX kernel's
# arithmetic and the same tolerance holds there too.
INT8_STEPS = ["prefill", "decode1", "decode2", "decode3"]
INT8_CASES = [pytest.param(layout, flag, step, id=prefix + name)
              for layout, flag, prefix in (("seq", "0", ""), ("dmajor", "0", "dmajor-"), ("dmajor", "1", "dmajor-int8dot-"))
              for step, name in enumerate(INT8_STEPS)]


@pytest.mark.parametrize("layout,int8dot,step", INT8_CASES)
def test_int8_cache_logits_match_jax_with_per_row_positions(small_logits_int8, layout, int8dot, step):
    ref, got = small_logits_int8(layout, int8dot)
    rel = _rel(got[:, step], ref[:, step])
    print(f"int8 {layout} int8dot={int8dot} step {step}: rel {rel:.3e}")
    assert rel <= REL_TOL


def test_dmajor_prefill_equals_the_seq_cache(small_logits_int8):
    """In the port the two layouts hold the same values, and at prefill their
    plain attention versions (K4's and K6's) are one computation: equal
    logits, bit for bit.  (At decode the seq int8 cache goes through K5's.)
    The all-int8 flag changes decode only."""
    seq, dmajor, int8dot = (small_logits_int8(*key)[1] for key in (("seq", "0"), ("dmajor", "0"), ("dmajor", "1")))
    np.testing.assert_array_equal(seq[:, 0], dmajor[:, 0])
    np.testing.assert_array_equal(dmajor[:, 0], int8dot[:, 0])
    assert not np.array_equal(dmajor[:, 1:], int8dot[:, 1:])


def test_int8_greedy_generate_matches_jax(small_pair):
    jmodel, port = small_pair
    ids = np.random.default_rng(5).integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    n = 12
    with jax_backend("pallas"):
        ref, ref_logits = _jax_greedy(jmodel, ids, n, kv="int8")
    got = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig("int8"))
    _assert_tokens_match(ref, got.numpy(), ref_logits)


@pytest.mark.parametrize("kv,int8dot", [("int8", "0"), ("int8", "1"), ("float4_e2m1", "0")],
                         ids=["int8", "int8-int8dot", "fp4"])
def test_dmajor_greedy_generate_matches_jax(small_pair, kv, int8dot):
    """Greedy tokens over a d-major cache against JAX op by op, up to the
    first near tie: the int8 cache through K6's plain version, then with the
    all-int8 flag through K7's at decode, and the fp4 cache, which exists in
    this layout only."""
    jmodel, port = small_pair
    ids = np.random.default_rng(5).integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    n = 12
    with kv_layout("dmajor", int8dot), jax_backend("pallas"):
        ref, ref_logits = _jax_greedy(jmodel, ids, n, kv=kv)
        got = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig(kv))
    _assert_tokens_match(ref, got.numpy(), ref_logits)


def test_generate_sampling_is_seeded(small_pair):
    """Greedy is the default; a temperature samples reproducibly from the
    seed, inside the top-k set of each step's logits."""
    _, port = small_pair
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, SMALL["vocab_size"], size=(2, 8)))
    kw = dict(kv_cache_config=MXConfig("int8"), temperature=0.9, top_k=5)
    a, logits = generate(port, ids, 6, seed=3, return_logits=True, **kw)
    b = generate(port, ids, 6, seed=3, **kw)
    c = generate(port, ids, 6, seed=4, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    top5 = logits.topk(5, dim=-1).indices
    assert (top5 == a[..., None]).any(-1).all()
