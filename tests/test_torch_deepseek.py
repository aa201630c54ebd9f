"""The port's DeepSeek-V3 model held against the JAX package on the same
numpy inputs (JAX on the CPU, its fused MLA kernel in interpret mode): the
noaux-tc router, the unquantized model with either query path, and a
3-layer MX DeepSeek through ``convert`` (logits per step over four caches,
the engine's staggered streams); within the port, the grouped MoE block
against the per-expert one and over the JAX package's stacked codes.

Tolerances: routing indices equal wherever the k-th and (k+1)-th choice
values differ by more than 1e-5, weights rel <= 1e-6 (sigmoid and sums
differ by ulps between the libraries); the unquantized model's logits rel
<= 2e-2; the MX model's logits rel <= 1e-1, the spread between JAX's own two
attention forms of this random model (``test_quantized_deepseek_matches_jax``),
and tokens equal up to JAX's first top-2 gap below 0.1, as
``tests/test_torch_mixtral.py``.  The model's latent is 512 wide and its
rope key 64, the widths B14 takes, so that the int8-dot path runs.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.config import MXConfig as JMXConfig
from torchmx_tpu.config import QAttentionConfig as JQAttn
from torchmx_tpu.config import QLinearConfig as JQLin
from torchmx_tpu.models import deepseek as jds
from torchmx_tpu.quant_api import quantize_llm_ as jquantize_llm_
from torchmx_tpu_torch import env_variables as env
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.convert import from_flat_params
from torchmx_tpu_torch.layers.mx_deepseek_attention import (
    MXInferenceDeepseekV3MoE,
    MXInferenceDeepseekV3MoEGrouped,
    MXInferenceMLAAttention,
)
from torchmx_tpu_torch.models import deepseek as tds
from torchmx_tpu_torch.models.generate import generate
from torchmx_tpu_torch.models.serve import DecodeEngine
from torchmx_tpu_torch.ops import cuda_lib, cuda_mla, cuda_moe
from torchmx_tpu_torch.quant_api import quantize_llm_

torch.set_num_threads(1)

FP4_FP8 = ("float4_e2m1", "float8_e4m3")
# JAX's tests/test_deepseek.py::tiny_config, with the latent 512 wide and the
# rope key 64 (B14's widths), 2 router groups and q_lora_rank 64.
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=128, q_lora_rank=64, kv_lora_rank=512,
            qk_rope_head_dim=64, qk_nope_head_dim=32, v_head_dim=32, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, moe_intermediate_size=64, n_group=2, topk_group=1, routed_scaling_factor=1.5,
            first_k_dense_replace=1)


def bf16(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def t_bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def j_bf16(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def flat_state(module) -> dict:
    _, state = nnx.split(module)
    return {".".join(map(str, k)): np.asarray(v.get_value()) for k, v in state.flat_state()}


@contextlib.contextmanager
def jax_env(**kw):
    """Set knobs on both packages' env modules (the JAX package's fused MLA
    kernel forced on), restoring them afterwards."""
    kw = {"TORCHMX_FUSED_ATTENTION": "pallas", **kw}
    old = {k: (getattr(jenv, k), getattr(env, k, None)) for k in kw}
    for k, v in kw.items():
        setattr(jenv, k, v)
        if hasattr(env, k):
            setattr(env, k, v)
    try:
        yield
    finally:
        for k, (j, t) in old.items():
            setattr(jenv, k, j)
            if t is not None:
                setattr(env, k, t)


# -- the router --------------------------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "planted-ties"])
@pytest.mark.parametrize("n_group", [1, 2])
def test_route_raw_matches_jax(n_group, ties):
    """The noaux-tc routing of the same router weight and correction bias:
    indices equal wherever the k-th and (k+1)-th choice values differ by more
    than 1e-5 (ties: the lower expert index, as jax.lax.top_k), weights rel
    <= 1e-6."""
    cfg = dict(TINY, n_group=n_group, topk_group=1)
    jmoe = jds.DeepseekV3MoE(jds.DeepseekV3Config(**cfg), rngs=nnx.Rngs(0))
    rng = np.random.default_rng(4)
    w = bf16(np.asarray(jmoe.gate.weight.get_value(), np.float32))
    bias = (rng.standard_normal(8) * 0.05).astype(np.float32)
    if ties:  # experts 1 and 5 copy 0 and 4: equal scores on every token, in both groups
        w[1], w[5], bias[1], bias[5] = w[0], w[4], bias[0], bias[4]
    jmoe.gate.weight.set_value(j_bf16(w))
    jmoe.gate.e_score_correction_bias.set_value(jnp.asarray(bias))
    x = bf16(rng.standard_normal((64, 128)))
    jw, ji = jmoe._route_raw(j_bf16(x))
    tmoe = tds.DeepseekV3MoE(tds.DeepseekV3Config(**cfg), device="cpu")
    with torch.no_grad():
        tmoe.gate.weight.copy_(t_bf16(w))
        tmoe.gate.e_score_correction_bias.copy_(torch.from_numpy(bias))
    tw, ti = tmoe._route_raw(t_bf16(x))
    assert ti.dtype == torch.int32
    choice = tds.noaux_choice(torch.sigmoid(cuda_moe.mx_router_logits_plain(t_bf16(x), t_bf16(w), f32=True)),
                              torch.from_numpy(bias), tmoe.config)
    vals = choice.sort(dim=-1, descending=True).values
    clear = (vals[:, 1] - vals[:, 2]).abs() > 1e-5
    np.testing.assert_array_equal(ti.numpy()[clear.numpy()], np.asarray(ji)[clear.numpy()])
    ok = (ti.numpy() == np.asarray(ji)).all(axis=1)
    np.testing.assert_allclose(tw.numpy()[ok], np.asarray(jw)[ok], rtol=1e-6, atol=0)
    if ties:
        assert not ((ti == 1) & ~(ti == 0).any(1, keepdim=True)).any()  # the lower index wins a tie


# -- the model ---------------------------------------------------------------------------------

CACHES = {"int8 seq": ("int8", {}), "fp4 seq": ("float4_e2m1", {}), "bf16 MLACache": (None, {}),
          "int8 d-major int8dot": ("int8", {"TORCHMX_KV_LAYOUT": "dmajor", "TORCHMX_ATTN_INT8_DOT": "1"})}


@pytest.fixture(scope="module")
def models():
    """A 3-layer JAX DeepSeek with random correction biases, carried to the
    port by ``convert`` and quantized by each package (fp4 weights, fp8
    activations; the port's MoE per expert, as JAX's)."""
    jmodel = jds.DeepseekV3ForCausalLM(jds.DeepseekV3Config(**TINY), rngs=nnx.Rngs(0))
    rng = np.random.default_rng(7)
    for layer in jmodel.model.layers[1:]:
        layer.mlp.gate.e_score_correction_bias.set_value(jnp.asarray(rng.standard_normal(8) * 0.05, jnp.float32))
    port = from_flat_params(flat_state(jmodel), tds.DeepseekV3Config(**TINY), device="cpu")
    assert type(port).__name__ == "DeepseekV3ForCausalLM"
    jq = JQLin(weights_config=JMXConfig(FP4_FP8[0]), activations_config=JMXConfig(FP4_FP8[1]))
    jquantize_llm_(jmodel, JQAttn(projection_config=jq), jq)
    tq = QLinearConfig(MXConfig(FP4_FP8[0]), MXConfig(FP4_FP8[1]))
    quantize_llm_(port, QAttentionConfig(tq), tq)
    assert type(port.model.layers[0].self_attn) is MXInferenceMLAAttention
    assert type(port.model.layers[1].mlp) is MXInferenceDeepseekV3MoE
    assert port.model.layers[1].mlp.shared_experts.down_proj.weight.fp4_pack == "pair"
    return jmodel, port


def _jax_steps(jmodel, ids, n, kv):
    """JAX's logits of a prefill and n - 1 greedy decode steps, op by op."""
    b, s = ids.shape
    caches = jmodel.init_cache(b, 128, kv)
    logits, caches = jmodel(jnp.asarray(ids), attention_mask=None, position_ids=jnp.arange(s)[None, :],
                            caches=caches, cache_position=0)
    ref = [np.asarray(logits[:, -1], np.float32)]
    for i in range(n - 1):
        tok = jnp.asarray(ref[-1].argmax(-1)[:, None], jnp.int32)
        logits, caches = jmodel(tok, attention_mask=None, position_ids=jnp.full((b, 1), s + i, jnp.int32),
                                caches=caches, cache_position=s + i)
        ref.append(np.asarray(logits[:, -1], np.float32))
    return np.stack(ref, axis=1)


@pytest.mark.parametrize("cache", list(CACHES))
def test_quantized_deepseek_matches_jax(models, cache):
    """Prefill of 8 and 3 greedy steps: every step's logits within 1e-1 of
    JAX's (fused MLA kernel, op by op) and the greedy tokens equal, up to
    JAX's first near tie; no kernel launches on the CPU.  The bound is the
    model's own spread: a one-ulp difference in an attention output grows
    through the fp8 activation grids of the next layers, and JAX's eager and
    fused attention forms of this model differ by 6e-2 to 1.1e-1 at every
    step over the int8 and bf16 caches."""
    jmodel, port = models
    elem, knobs = CACHES[cache]
    ids = np.random.default_rng(13).integers(0, 256, (2, 8)).astype(np.int32)
    n = 4
    with jax_env(**knobs):
        ref = _jax_steps(jmodel, ids, n, None if elem is None else JMXConfig(elem))
        eager = cuda_mla.ROUTES["eager"]
        got, got_logits = generate(port, torch.from_numpy(ids), n, kv_cache_config=None if elem is None
                                   else MXConfig(elem), return_logits=True)
    assert cuda_mla.ROUTES["eager"] - eager == (3 if knobs else 0)  # d-major prefill: JAX's eager route, per layer
    got, got_logits = got.numpy(), got_logits.numpy()
    for row in range(2):
        for i in range(n):
            r = float(np.abs(got_logits[row, i] - ref[row, i]).max() / np.abs(ref[row, i]).max())
            assert r <= 1e-1, f"row {row} step {i}: logits rel {r}"
            if got[row, i] != ref[row, i].argmax():
                top2 = np.sort(ref[row, i])[-2:]
                assert top2[1] - top2[0] < 0.1, f"row {row} step {i}: tokens differ at gap {top2[1] - top2[0]}"
                break
    assert sum(cuda_lib.LAUNCHES.values()) == 0


SCHEDULE = {0: 0, 2: 1}  # step -> request admitted before it
STEPS = 5


def test_staggered_streams_match_the_jax_engine(models):
    """Two requests admitted at steps 0 and 2 into a 2-slot engine over the
    int8 seq latent cache: the greedy streams equal JAX's, stepped op by
    op the way its engine runs (each prompt prefilled into a single-slot
    cache copied into its slot; every step decodes all slots at per-row
    positions), up to JAX's first near tie."""
    jmodel, port = models
    prompts = [np.random.default_rng(30 + i).integers(0, 256, 8).tolist() for i in range(2)]
    eng = DecodeEngine(port, 2, 128, kv_cache_config=MXConfig("int8"), device="cpu")
    got, slots = {i: [] for i in range(2)}, {}
    for step in range(STEPS):
        if step in SCHEDULE:
            slots[eng.add(prompts[SCHEDULE[step]])] = SCHEDULE[step]
        for slot, tok in eng.step().items():
            got[slots[slot]].append(int(tok))
    kv = JMXConfig("int8")
    with jax_env():
        caches = jmodel.init_cache(2, 128, kv)
        pos, nxt, active = np.zeros(2, np.int32), np.zeros(2, np.int32), np.zeros(2, bool)
        pending = [None] * 2
        ref, ref_logits = {i: [] for i in range(2)}, {i: [] for i in range(2)}
        for step in range(STEPS):
            if step in SCHEDULE:
                slot = SCHEDULE[step]
                ids = np.asarray(prompts[slot], np.int32)[None]
                lg, small = jmodel(jnp.asarray(ids), attention_mask=None, position_ids=jnp.arange(ids.shape[1])[None],
                                   caches=jmodel.init_cache(1, 128, kv), cache_position=0)
                caches = jax.tree.map(lambda big, one: big.at[slot].set(one[0]) if hasattr(big, "ndim") else big,
                                      caches, small)
                pending[slot] = np.asarray(lg[0, -1], np.float32)
                nxt[slot], pos[slot], active[slot] = pending[slot].argmax(), ids.shape[1], True
            lg, caches = jmodel(jnp.asarray(nxt[:, None]), attention_mask=None, position_ids=jnp.asarray(pos[:, None]),
                                caches=caches, cache_position=jnp.asarray(pos))
            lg = np.asarray(lg[:, -1], np.float32)
            for slot in np.flatnonzero(active):
                ref[slot].append(int(nxt[slot]))
                ref_logits[slot].append(pending[slot])
                pending[slot], nxt[slot] = lg[slot], lg[slot].argmax()
                pos[slot] += 1
    for req in ref:
        assert len(ref[req]) == len(got[req])
        for i, (r, g) in enumerate(zip(ref[req], got[req])):
            if r != g:
                top2 = np.sort(ref_logits[req][i])[-2:]
                assert top2[1] - top2[0] < 0.1, f"request {req} differs at step {i}"
                break


def test_grouped_int8_block_equals_per_expert_bitwise():
    """int8 weights, fp8 activations: the grouped DeepSeek MoE block (K2 then
    plain B12 over stacked codes) gives the per-expert block's (plain B6 with
    fused fq) bytes, shared experts and correction bias included."""
    cfg = tds.DeepseekV3Config(**TINY)
    blk = tds.DeepseekV3MoE(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        blk.gate.e_score_correction_bias.normal_(0, 0.05, generator=torch.Generator().manual_seed(6))
    q = QLinearConfig(MXConfig("int8"), MXConfig("float8_e4m3"))
    per_expert = MXInferenceDeepseekV3MoE.from_float(blk, q)
    blk.grouped, blk.grouped_tm = True, 8
    grouped = MXInferenceDeepseekV3MoE.from_float(blk, q)
    assert type(grouped) is MXInferenceDeepseekV3MoEGrouped and type(per_expert) is MXInferenceDeepseekV3MoE
    x = torch.randn(2, 24, 128, generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    assert torch.equal(grouped(x), per_expert(x))
    assert torch.equal(grouped.gate.e_score_correction_bias, blk.gate.e_score_correction_bias)


@pytest.mark.parametrize("q_lora_rank", [None, 64], ids=["q_proj", "q_a-q_b"])
def test_bf16_deepseek_matches_jax(q_lora_rank):
    """The unquantized model through ``convert`` over the bf16 ``MLACache``:
    a prefill of 6 and one decode step at per-row positions, logits within
    2e-2 of JAX's (fused MLA kernel), with either query path."""
    cfg = dict(TINY, num_hidden_layers=2, q_lora_rank=q_lora_rank)
    jmodel = jds.DeepseekV3ForCausalLM(jds.DeepseekV3Config(**cfg), rngs=nnx.Rngs(3))
    port = from_flat_params(flat_state(jmodel), tds.DeepseekV3Config(**cfg), device="cpu")
    assert hasattr(port.model.layers[0].self_attn, "q_proj") == (q_lora_rank is None)
    ids = np.random.default_rng(21).integers(0, 256, (2, 6)).astype(np.int32)
    nxt = np.array([[5], [7]], np.int32)
    with jax_env():
        jc = jmodel.init_cache(2, 128, None)
        jl0, jc = jmodel(jnp.asarray(ids), attention_mask=None, position_ids=jnp.arange(6)[None], caches=jc,
                         cache_position=0)
        jl1, _ = jmodel(jnp.asarray(nxt), attention_mask=None, position_ids=jnp.full((2, 1), 6, jnp.int32),
                        caches=jc, cache_position=jnp.asarray([6, 6], jnp.int32))
    tc = port.init_cache(2, 128, None)
    with torch.inference_mode():
        tl0 = port(torch.from_numpy(ids).long(), caches=tc, cache_position=0)
        tl1 = port(torch.from_numpy(nxt).long(), caches=tc, cache_position=torch.tensor([6, 6], dtype=torch.int32))
    for t, j in ((tl0, jl0), (tl1, jl1)):
        j = np.asarray(j, np.float32)
        assert float(np.abs(to_np(t) - j).max() / np.abs(j).max()) <= 2e-2


def test_grouped_moe_from_jax_stacked_codes():
    """A DeepSeek MoE block's experts stacked and quantized by the JAX
    package's grouped quantizer, carried across by
    ``grouped_moe_from_buffers`` with the correction bias and the shared
    experts: the port's own grouped block's bytes, and its output."""
    from torchmx_tpu.layers.mx_mixtral_moe import MXInferenceMixtralMoeBlockGrouped as JGrouped
    from torchmx_tpu_torch.convert import grouped_moe_from_buffers
    from torchmx_tpu_torch.layers.mx_llama_attention import MXInferenceLlamaMLP

    cfg = tds.DeepseekV3Config(**TINY)
    blk = tds.DeepseekV3MoE(cfg, device="cpu", generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        blk.gate.e_score_correction_bias.normal_(0, 0.05, generator=torch.Generator().manual_seed(9))
    blk.grouped, blk.grouped_tm = True, 8
    q = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    own = MXInferenceDeepseekV3MoE.from_float(blk, q)
    codes, scales = {}, {}
    for name in ("w1", "w3", "w2"):
        jq, js = JGrouped._quantize_stacked(j_bf16(to_np(getattr(blk, name))), "float4_e2m1")
        codes[name], scales[name] = np.asarray(jq), np.asarray(js)
    carried = grouped_moe_from_buffers(blk.config, to_np(blk.gate.weight).astype(jnp.bfloat16), codes, scales, q,
                                       own.kernel_elem, device="cpu",
                                       gate_bias=blk.gate.e_score_correction_bias.detach().numpy(),
                                       shared_experts=MXInferenceLlamaMLP.from_float(blk.shared_experts, q))
    assert type(carried) is MXInferenceDeepseekV3MoEGrouped
    for name in ("w1", "w3", "w2"):
        for k in ("codes", "scale"):
            assert torch.equal(getattr(carried, f"{name}_{k}"), getattr(own, f"{name}_{k}"))
    carried.grouped_tm = 8
    x = torch.randn(2, 12, 128, generator=torch.Generator().manual_seed(10)).to(torch.bfloat16)
    assert torch.equal(carried(x), own(x))


