"""The port's continuous-batching ``DecodeEngine``
(``torchmx_tpu_torch/models/serve.py``) on the CPU: the counterparts of the
JAX engine's tests (``tests/test_serve.py``) for what this slice covers, on a
2-layer MXFP4-weight / MXFP8-activation model over an int8 (and fp8) MX KV
cache, and the greedy streams of a staggered run against the JAX engine.

Within the port, streams are compared exactly: batch rows are independent
and the plain path is deterministic.  Against JAX, tokens must be equal up
to the first step where JAX's top-2 logit gap is below 0.1 (a near tie that
a 1-ulp difference may flip), as in ``test_torch_llama.py``.
"""

import numpy as np
import pytest
import torch

from torchmx_tpu_torch import env_variables as env
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.models.generate import generate
from torchmx_tpu_torch.models.llama import LlamaConfig
from torchmx_tpu_torch.models.serve import DecodeEngine
from torchmx_tpu_torch.quant_api import build_quantized_llama

torch.set_num_threads(1)

SMALL = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=128)
INT8, FP8 = MXConfig("int8"), MXConfig("float8_e4m3")


@pytest.fixture(scope="module")
def model():
    q = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    return build_quantized_llama(LlamaConfig(**SMALL), QAttentionConfig(q), q, "cpu",
                                 torch.Generator().manual_seed(0))


def engine(model, max_batch, max_len=64, kv=INT8, **kw) -> DecodeEngine:
    return DecodeEngine(model, max_batch, max_len, kv_cache_config=kv, device="cpu", **kw)


def prompt_of(seed, n):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], n).tolist()


def ref_tokens(model, prompt, n, kv=INT8):
    return generate(model, torch.tensor([prompt]), n, kv_cache_config=kv)[0].tolist()


def collect(eng, slot, n):
    toks = []
    while len(toks) < n:
        out = eng.step()
        if slot in out:
            toks.append(out[slot])
    return toks


@pytest.mark.parametrize("kv", [INT8, FP8], ids=["int8", "fp8"])
@pytest.mark.parametrize("max_batch", [1, 4])
def test_engine_matches_generate_single_slot(model, kv, max_batch):
    prompt = prompt_of(0, 9)
    eng = engine(model, max_batch, kv=kv)
    assert eng.max_len == 128  # rounded up to the kernels' tile multiple
    assert collect(eng, eng.add(prompt), 10) == ref_tokens(model, prompt, 10, kv)


def test_engine_staggered_requests_are_independent(model):
    """A request joining mid-flight produces the tokens it produces alone,
    and slots recycle after release."""
    p_a, p_b, p_c = prompt_of(1, 6), prompt_of(2, 11), prompt_of(3, 4)
    want_a, want_b, want_c = ref_tokens(model, p_a, 12), ref_tokens(model, p_b, 8), ref_tokens(model, p_c, 5)
    eng = engine(model, 2)
    sa = eng.add(p_a)
    got_a = collect(eng, sa, 4)  # A decodes alone for a while
    sb = eng.add(p_b)
    assert sb != sa
    got_b = []
    while len(got_b) < 8:
        out = eng.step()
        if sa in out and len(got_a) < 12:
            got_a.append(out[sa])
        if sb in out:
            got_b.append(out[sb])
    while len(got_a) < 12:
        got_a.append(eng.step()[sa])
    assert got_a == want_a and got_b == want_b
    eng.release(sa)
    eng.release(sb)
    sc = eng.add(p_c)
    assert sc in (sa, sb)
    assert collect(eng, sc, 5) == want_c
    with pytest.raises(RuntimeError, match="no free slots"):
        eng.add(p_a), eng.add(p_b)


def test_engine_eos_auto_release(model):
    prompt = prompt_of(4, 6)
    want = ref_tokens(model, prompt, 3)
    eos = next(t for t in want[1:] if t != want[0])  # the first token must be emitted
    cut = want.index(eos)
    eng = engine(model, 2, eos_token_id=eos)
    slot = eng.add(prompt)
    assert eng.is_active(slot)
    emitted, steps = [], 0
    while eng.is_active(slot):
        out = eng.step()
        emitted += [out[slot]] if slot in out else []
        steps += 1
        assert steps < 64
    assert emitted == want[:cut]  # EOS not emitted
    assert eng.finished_reason[slot] == "eos"
    assert slot in eng.free_slots()
    slot2 = eng.add(prompt)  # add() on the recycled slot clears the reason
    assert slot2 == slot and slot not in eng.finished_reason
    # A prompt whose first continuation is EOS emits nothing.
    eng2 = engine(model, 1, eos_token_id=[want[0], 999])
    s = eng2.add(prompt)
    assert not eng2.is_active(s) and eng2.finished_reason[s] == "eos" and eng2.step() == {}


@pytest.mark.parametrize("kv", [INT8, FP8], ids=["int8", "fp8"])
def test_engine_cache_full_is_signalled_and_the_last_token_emitted(model, kv):
    """A slot run to ``max_len``: every emittable token arrives (positions
    len(prompt)..max_len; the last one needs no further cache write, and the
    step that emits it writes at a clamped position), then the slot is
    released with reason ``cache_full``; its neighbour is unaffected."""
    prompt, other = prompt_of(5, 120), prompt_of(6, 5)
    eng = engine(model, 2, 128, kv=kv)
    slot, so = eng.add(prompt), eng.add(other)
    got, got_o = [], []
    while eng.is_active(slot):
        out = eng.step()
        got += [out[slot]] if slot in out else []
        got_o.append(out[so])
        assert len(got) <= 128
    assert eng.finished_reason[slot] == "cache_full"
    assert eng.pos[slot] == 0  # stale position zeroed on eviction
    assert len(got) == 128 - len(prompt) + 1
    assert got[:8] == ref_tokens(model, prompt, 8, kv)  # generate()'s cache holds 120 + 8
    got_o += [eng.step()[so] for _ in range(3)]  # the drained slot decodes on, inactive
    assert got_o == ref_tokens(model, other, len(got_o), kv)


def test_chunked_prefill_matches_and_keeps_decode_cadence(model):
    """Chunked admission: the admitted stream equals the whole-prompt
    engine's, and an active slot keeps emitting at every step meanwhile."""
    prompt_a, prompt_b = prompt_of(7, 6), prompt_of(8, 48)  # 6 chunks of 8
    ref = engine(model, 2)
    sa = ref.add(prompt_a)
    ref_a_first = collect(ref, sa, 3)
    sb = ref.add(prompt_b)
    ref_b = [o[sb] for o in (ref.step() for _ in range(10)) if sb in o]

    eng = engine(model, 2, prefill_chunk=8)
    ca = eng.add(prompt_a)  # chunked too: one chunk
    assert collect(eng, ca, 3) == ref_a_first
    cb = eng.add(prompt_b)
    assert eng.is_active(cb)  # reserved at once
    cadence, got_b = [], []
    for _ in range(16):
        out = eng.step()
        cadence.append(ca in out)
        if cb in out:
            got_b.append(out[cb])
    assert all(cadence), cadence
    assert got_b and got_b[: len(ref_b)] == ref_b[: len(got_b)], (got_b, ref_b)


def test_chunked_prefill_short_prompt_and_release(model):
    eng = engine(model, 1, prefill_chunk=16)
    s = eng.add([3, 1, 4])
    assert eng.free_slots() == []  # reserved while pending
    assert collect(eng, s, 4) == ref_tokens(model, [3, 1, 4], 4)
    eng.release(s)
    assert eng.free_slots() == [0]
    s2 = eng.add(list(range(40)))  # releasing a pending slot clears the queue
    eng.release(s2)
    assert not eng._pending and eng.free_slots() == [0]
    with pytest.raises(ValueError, match="must divide"):
        engine(model, 1, prefill_chunk=48)


@pytest.mark.parametrize("kv", [INT8, FP8], ids=["int8", "fp8"])
def test_prefix_cache_exact_streams_and_misses(model, kv):
    """Prompts extending a registered prefix emit exactly the stream of an
    engine without it, and the prefill is skipped; prompts that do not
    extend it (or equal it) are unaffected."""
    system, user_a, user_b, other = prompt_of(9, 24), prompt_of(10, 7), prompt_of(11, 13), prompt_of(12, 20)
    prompts = (system + user_a, system + user_b, other, list(system))
    ref = engine(model, 4, kv=kv)
    wants = [collect(ref, ref.add(p), 6) for p in prompts]
    eng = engine(model, 4, kv=kv)
    eng.cache_prefix(system)
    gots, hits = [], []
    for p in prompts:
        gots.append(collect(eng, eng.add(p), 6))
        hits.append(eng.prefix_hit_tokens)
    assert gots == wants
    assert hits == [24, 48, 48, 48]  # the misses added nothing


def test_prefix_cache_longest_match_and_drop(model):
    base = prompt_of(13, 8)
    longer, tail = base + prompt_of(14, 8), prompt_of(15, 5)
    ref = engine(model, 1)
    want = collect(ref, ref.add(longer + tail), 6)
    eng = engine(model, 1)
    eng.cache_prefix(base)
    h = eng.cache_prefix(longer)
    s = eng.add(longer + tail)
    assert eng.prefix_hit_tokens == len(longer)  # longest match wins
    assert collect(eng, s, 6) == want
    eng.release(s)
    eng.drop_prefix(h)
    eng.prefix_hit_tokens = 0
    s2 = eng.add(longer + tail)
    assert eng.prefix_hit_tokens == len(base)  # falls back to the shorter
    assert collect(eng, s2, 6) == want


def test_prefix_cache_with_chunked_prefill(model):
    """With chunks the reused length rounds down to the chunk grid."""
    system, user = prompt_of(16, 21), prompt_of(17, 9)
    ref = engine(model, 1)
    want = collect(ref, ref.add(system + user), 8)
    eng = engine(model, 1, prefill_chunk=8)
    eng.cache_prefix(system)
    s = eng.add(system + user)
    assert eng.prefix_hit_tokens == 16
    assert collect(eng, s, 8) == want


def test_prefix_cache_near_full(model):
    """A prefixed prompt that nearly fills the cache: the remainder is
    admitted at its true length, so its window ends inside the cache (the
    reference has to shift a bucket-wide window down here)."""
    system, user = prompt_of(18, 100), prompt_of(19, 25)
    ref = engine(model, 1, 128)
    want = collect(ref, ref.add(system + user), 3)
    eng = engine(model, 1, 128)
    eng.cache_prefix(system)
    s = eng.add(system + user)
    assert eng.prefix_hit_tokens == 100
    assert collect(eng, s, 3) == want
    with pytest.raises(ValueError, match="prefix length"):
        eng.cache_prefix(list(range(128)))
    eng.release(s)
    with pytest.raises(ValueError, match="prompt length"):
        eng.add(list(range(129)))


@pytest.mark.parametrize("kv,int8dot", [(INT8, "0"), (INT8, "1"), (MXConfig("float4_e2m1"), "0")],
                         ids=["int8", "int8-int8dot", "fp4"])
def test_dmajor_engine_streams_whole_chunked_prefixed(model, monkeypatch, kv, int8dot):
    """Over a d-major cache (the layout comes from the env flag, as in the
    reference) a request's stream is the same admitted whole, in chunks and
    over a cached prefix, among other requests, and it is the one
    ``generate`` gives over the same cache."""
    system, user, other = prompt_of(40, 24), prompt_of(41, 9), prompt_of(42, 13)
    monkeypatch.setattr(env, "TORCHMX_KV_LAYOUT", "dmajor")
    monkeypatch.setattr(env, "TORCHMX_ATTN_INT8_DOT", int8dot)

    whole = engine(model, 2, kv=kv)
    assert whole._caches[0].layout == "dmajor" and whole._caches[0].max_len == 128
    collect(whole, whole.add(other), 2)  # the other request decodes meanwhile
    want = collect(whole, whole.add(system + user), 8)
    chunked = engine(model, 2, kv=kv, prefill_chunk=8)
    chunked.add(other)
    got_chunked = collect(chunked, chunked.add(system + user), 8)
    prefixed = engine(model, 2, kv=kv)
    prefixed.cache_prefix(system)
    got_prefixed = collect(prefixed, prefixed.add(system + user), 8)
    assert prefixed.prefix_hit_tokens == len(system)
    assert want == got_chunked == got_prefixed
    assert want == ref_tokens(model, system + user, 8, kv)


def test_engine_stop_sequences(model):
    """A slot releases (reason "stop") when its emitted stream ends with a
    stop sequence; the matching tokens are emitted; other slots go on."""
    prompt = prompt_of(20, 5)
    ref = ref_tokens(model, prompt, 16)
    stop = tuple(ref[3:6])
    eng = engine(model, 2, stop_sequences=[stop, (999, 998)])
    s1, s2 = eng.add(prompt), eng.add(prompt_of(21, 3))
    got1, got2 = [], []
    for _ in range(16):
        out = eng.step()
        got1 += [out[s1]] if s1 in out else []
        got2 += [out[s2]] if s2 in out else []
    expect = next(ref[: i + 1] for i in range(len(ref))
                  if i + 1 >= len(stop) and tuple(ref[i + 1 - len(stop): i + 1]) == stop)
    assert got1 == expect
    assert eng.finished_reason[s1] == "stop" and not eng.is_active(s1)
    assert eng.is_active(s2) and len(got2) == 16


def test_engine_logprobs_match_full_forward(model):
    """Opt-in logprobs equal log_softmax of the model's own logits at each
    emitted position, recomputed by a prefill over prompt + tokens so far
    (another attention kernel and other matmul shapes than the decode step:
    atol 5e-2, the JAX test's)."""
    prompt = prompt_of(22, 5)
    eng = engine(model, 1, return_logprobs=True)
    slot = eng.add(prompt)
    toks = collect(eng, slot, 6)
    lps = eng.logprobs[slot]
    assert len(lps) == 6
    seq = list(prompt)
    for t, lp in zip(toks, lps):
        caches = model.init_cache(1, 128, INT8)
        with torch.inference_mode():
            logits = model(torch.tensor([seq]), caches=caches, cache_position=0, last_only=True)[0, -1]
        full = torch.log_softmax(logits.float(), -1)
        np.testing.assert_allclose(float(full[t]), lp, atol=5e-2, rtol=5e-2)
        seq.append(t)
    assert toks == ref_tokens(model, prompt, 6)  # recording them changes no token
    eng.release(slot)
    assert slot not in eng.logprobs


def test_engine_sampling_is_seeded(model):
    prompt = prompt_of(23, 8)
    kw = dict(temperature=0.8, top_k=8)
    a, b, c = engine(model, 1, seed=7, **kw), engine(model, 1, seed=7, **kw), engine(model, 1, seed=99, **kw)
    ta, tb, tc = (collect(e, e.add(prompt), 16) for e in (a, b, c))
    assert ta == tb and ta != tc
    assert all(0 <= t < SMALL["vocab_size"] for t in ta)


@pytest.mark.parametrize("kw", [dict(speculative_draft_len=3), dict(ring=True), dict(mesh=object()),
                                dict(kv_cache_config=None)], ids=lambda kw: next(iter(kw)))
def test_unported_engine_features_raise(model, kw):
    args = dict(kv_cache_config=INT8, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        DecodeEngine(model, 1, 64, **args)


def test_engine_device_must_hold_the_model(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model lies on cpu"):
        DecodeEngine(model, 1, 64, kv_cache_config=INT8)


# -- against the JAX engine ---------------------------------------------------------

# A staggered run: request 0 admitted before step 0, 1 before step 1, 2
# before step 3; 6 steps; three slots.
SCHEDULE = {0: 0, 1: 1, 3: 2}
STEPS = 6


def _run_schedule(eng, prompts):
    streams, slots = {i: [] for i in range(len(prompts))}, {}
    for step in range(STEPS):
        if step in SCHEDULE:
            slots[eng.add(prompts[SCHEDULE[step]])] = SCHEDULE[step]
        for slot, tok in eng.step().items():
            streams[slots[slot]].append(int(tok))
    return streams


def _jax_schedule_op_by_op(jmodel, prompts, kv):
    """The same schedule on the JAX model, op by op (no ``jit``), the way the
    JAX engine runs it: each prompt prefills a single-slot cache that is then
    copied into its slot of the batch caches, and every step decodes all
    three slots at per-row positions, idle ones at position 0.  Returns the
    streams and, per request, the fp32 logits each token was picked from."""
    import jax
    import jax.numpy as jnp

    nslots = len(prompts)
    caches = jmodel.init_cache(nslots, 128, kv)
    pos, nxt, active = np.zeros(nslots, np.int32), np.zeros(nslots, np.int32), np.zeros(nslots, bool)
    pending_logits = [None] * nslots
    streams, logits_of = {i: [] for i in range(nslots)}, {i: [] for i in range(nslots)}
    for step in range(STEPS):
        if step in SCHEDULE:
            slot = req = SCHEDULE[step]  # slots fill in order: request i takes slot i
            ids = np.asarray(prompts[req], np.int32)[None]
            lg, small = jmodel(jnp.asarray(ids), attention_mask=None,
                               position_ids=jnp.arange(ids.shape[1])[None, :],
                               caches=jmodel.init_cache(1, 128, kv), cache_position=0)
            caches = jax.tree.map(lambda big, one: big.at[slot].set(one[0]) if hasattr(big, "ndim") else big,
                                  caches, small)
            pending_logits[slot] = np.asarray(lg[0, -1], np.float32)
            nxt[slot], pos[slot], active[slot] = pending_logits[slot].argmax(), ids.shape[1], True
        lg, caches = jmodel(jnp.asarray(nxt[:, None]), attention_mask=None, position_ids=jnp.asarray(pos[:, None]),
                            caches=caches, cache_position=jnp.asarray(pos))
        lg = np.asarray(lg[:, -1], np.float32)
        for slot in np.flatnonzero(active):
            streams[slot].append(int(nxt[slot]))
            logits_of[slot].append(pending_logits[slot])
            pending_logits[slot], nxt[slot] = lg[slot], lg[slot].argmax()
            pos[slot] += 1
    return streams, logits_of


def _assert_streams_match(ref, got, ref_logits, what, tie_gap=0.1):
    """Equal up to the first near tie of the reference (top-2 gap < ``tie_gap``)."""
    for req in ref:
        assert len(ref[req]) == len(got[req]), (what, req)
        for i, (r, g) in enumerate(zip(ref[req], got[req])):
            if r != g:
                top2 = np.sort(ref_logits[req][i])[-2:]
                gap = float(top2[1] - top2[0])
                print(f"{what}: request {req} step {i}: tokens {r} vs {g}, JAX top-2 gap {gap:.4f}")
                assert gap < tie_gap, f"{what}: request {req} differs at step {i} with gap {gap}"
                break


def test_staggered_streams_match_the_jax_engine():
    """Greedy streams of a staggered 3-request run (int8 cache, JAX on the
    Pallas path in interpret mode) against JAX, up to the first near tie.

    The JAX engine jits its steps, and jitted JAX differs from its own
    op-by-op arithmetic by more than a near tie at times (XLA drops
    intermediate bf16 roundings); under ``jax.disable_jit()`` the JAX engine
    does run but takes minutes here.  So the reference is the JAX model
    stepped op by op through the engine's schedule (``_jax_schedule_op_by_op``),
    as ``test_torch_llama._jax_greedy`` drives ``generate``'s.  The jitted JAX
    engine is held to that reference too, to show that the op-by-op loop runs
    the schedule the JAX engine runs: the same stream lengths, and equal tokens
    up to the first step whose gap is below 0.2 (``jit`` flips a 0.11 gap
    here)."""
    from flax import nnx

    from tests.test_torch_llama import JLlama, JLlamaConfig, JMXConfig, _quantize_pair, jax_backend
    from torchmx_tpu.models.serve import DecodeEngine as JEngine

    jmodel, port = _quantize_pair(JLlama(JLlamaConfig(**SMALL), rngs=nnx.Rngs(0)), SMALL)
    prompts = [prompt_of(30 + i, n) for i, n in enumerate((6, 11, 4))]
    with jax_backend("pallas"):
        ref, ref_logits = _jax_schedule_op_by_op(jmodel, prompts, JMXConfig("int8"))
        jitted = _run_schedule(JEngine(jmodel, max_batch=3, max_len=128, kv_cache_config=JMXConfig("int8")), prompts)
    got = _run_schedule(engine(port, 3, 128), prompts)
    assert [len(ref[i]) for i in range(3)] == [6, 5, 3]
    _assert_streams_match(ref, jitted, ref_logits, "jitted JAX engine", tie_gap=0.2)
    _assert_streams_match(ref, got, ref_logits, "port engine")
