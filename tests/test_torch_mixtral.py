"""The port's Mixtral slice held against the JAX package on the same numpy
inputs: routing (with planted ties), the token grouping and combine around
the grouped GEMM, the plain B12 ``mx_grouped_matmul`` against the Pallas
kernel it replaces (interpret mode), the stacked quantizer, the plain MoE
block in its three modes, the MX per-expert and grouped blocks, and a
2-layer fp4 grouped Mixtral through ``convert``; within the port, the
grouped int8 block against the per-expert one bit for bit, a small
``DecodeEngine`` stream, the Mistral window guard and the registry.  On a
machine with a card, the router kernel's row invariance (B12 on the card:
``tests/test_torch_gpu_grouped.py``).

Tolerances: routing indices equal, routing weights within 2 f32 ulps
(softmax's exp differs between the libraries); grouping, combine and the
stacked bytes exact; the plain B12 within one bf16 step of the Pallas
kernel (fp32 sums in another order); the MoE blocks ``atol = rtol = 4e-2``
(plain) and ``5e-2`` (MX), the JAX tests' own tolerances between two forms
of one block (``tests/test_mixtral.py``); the model's logits rel <= 2e-2
and greedy tokens equal up to JAX's first top-2 gap below 0.1, as
``tests/test_torch_llama.py``.  The model test gives the tiny config
head_dim 128, so that the JAX Pallas attention kernel runs (at head_dim 32
it falls back to its dequantize path).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.config import MXConfig as JMXConfig
from torchmx_tpu.config import QAttentionConfig as JQAttn
from torchmx_tpu.config import QLinearConfig as JQLin
from torchmx_tpu.layers.mx_mixtral_moe import MXInferenceMixtralMoeBlock as JMX
from torchmx_tpu.layers.mx_mixtral_moe import MXInferenceMixtralMoeBlockGrouped as JGrouped
from torchmx_tpu.models import mixtral as jmix
from torchmx_tpu.ops import pallas_moe as jmoe
from torchmx_tpu.quant_api import quantize_llm_ as jquantize_llm_
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.convert import from_flat_params, grouped_moe_from_buffers
from torchmx_tpu_torch.layers.mx_mistral_attention import MXInferenceMistralAttention
from torchmx_tpu_torch.layers.mx_mixtral_moe import MXInferenceMixtralMoeBlock, MXInferenceMixtralMoeBlockGrouped
from torchmx_tpu_torch.models import mixtral as tmix
from torchmx_tpu_torch.models.generate import generate
from torchmx_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
from torchmx_tpu_torch.models.serve import DecodeEngine
from torchmx_tpu_torch.mx_array import quantize_stacked
from torchmx_tpu_torch.ops import cuda_lib, cuda_moe, moe
from torchmx_tpu_torch.quant_api import build_quantized, quantize_llm_

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128, num_local_experts=4, num_experts_per_tok=2)
TM = 8
FP4_FP8 = ("float4_e2m1", "float8_e4m3")


def bf16(x) -> np.ndarray:
    """numpy float32 values on the bf16 grid."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def t_bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def j_bf16(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16)


def flat_state(module) -> dict:
    _, state = nnx.split(module)
    return {".".join(map(str, k)): np.asarray(v.get_value()) for k, v in state.flat_state()}


def port_block(jblock, config) -> tmix.MixtralSparseMoeBlock:
    """The port's plain block holding a JAX block's bf16 weights."""
    blk = tmix.MixtralSparseMoeBlock(config, device="cpu")
    params = flat_state(jblock)
    with torch.no_grad():
        for name, dst in blk.named_parameters():
            dst.copy_(torch.from_numpy(params[name].astype(np.float32)).to(torch.bfloat16))
    return blk


def within_bf16_steps(got: np.ndarray, ref: np.ndarray, steps: float = 1.0) -> bool:
    """|got - ref| within ``steps`` bf16 steps of ref (the smallest normal's near 0)."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    return bool((np.abs(got - ref) <= steps * ulp).all())


# -- routing, grouping, combine ------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "planted-ties"])
def test_route_topk_raw_matches_jax(ties):
    """Indices equal (ties: the lower expert index, as jax.lax.top_k), the
    renormalized weights within 2 f32 ulps."""
    logits = bf16(np.random.default_rng(0).standard_normal((64, 8)) * 2)
    if ties:  # experts 0/1 and 3/5 tie exactly on every token; 6 ties 2 on half of them
        logits[:, 1] = logits[:, 0]
        logits[:, 5] = logits[:, 3]
        logits[::2, 6] = logits[::2, 2]
    jv, ji = jmix.route_topk_raw(j_bf16(logits), 2)
    tv, ti = tmix.route_topk_raw(t_bf16(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2 * 2.0 ** -23, atol=0)
    if ties:
        assert not np.any((ti.numpy() == 1) & ~np.any(ti.numpy() == 0, axis=1, keepdims=True))
    cw_j = np.asarray(jmix.route_topk(j_bf16(logits), 2))
    np.testing.assert_allclose(tmix.route_topk(t_bf16(logits), 2).numpy(), cw_j, rtol=2 * 2.0 ** -23, atol=0)


GROUPINGS = {"T50": (50, None), "T64": (64, None), "T64-expert-2-empty": (64, 2)}


@pytest.mark.parametrize("case", list(GROUPINGS))
def test_group_tokens_and_combine_match_jax(case):
    T, empty = GROUPINGS[case]
    rng = np.random.default_rng(1)
    top_idx = rng.integers(0, 4, (T, 2)).astype(np.int32)
    if empty is not None:
        top_idx[top_idx == empty] = 3
    x = bf16(rng.standard_normal((T, 16)))
    jxs, jte, jtr, jdest = jmoe.group_tokens(j_bf16(x), jnp.asarray(top_idx), TM, 4)
    txs, tte, ttr, tdest = moe.group_tokens(t_bf16(x), torch.from_numpy(top_idx), TM, 4)
    assert txs.shape[0] == moe.plan_group_layout(T, 2, 4, TM) == jxs.shape[0]
    np.testing.assert_array_equal(txs.float().numpy(), np.asarray(jxs, np.float32))
    for t, j in ((tte, jte), (ttr, jtr), (tdest, jdest)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    y = bf16(rng.standard_normal((txs.shape[0], 16)))
    vals = rng.random((T, 2)).astype(np.float32)
    got = moe.combine_tokens(t_bf16(y), tdest, torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmoe.combine_tokens(j_bf16(y), jdest, jnp.asarray(vals))))


# -- B12's plain version against the Pallas kernel -----------------------------------------


@pytest.mark.parametrize("elem", [None, "int8", "float8_e4m3", "float6_e3m2"])
def test_grouped_matmul_plain_matches_pallas_kernel(elem):
    """Every row of the port's plain B12 within one bf16 step of
    ``pallas_moe.grouped_matmul`` (interpret mode), on a layout with dead
    tiles and padding rows."""
    rng = np.random.default_rng(2)
    E, K, N, T = 4, 128, 256, 20
    top_idx = rng.integers(0, E, (T, 2)).astype(np.int32)
    x = bf16(rng.standard_normal((T, K)))
    w = bf16(rng.standard_normal((E, K, N)) * 0.1)
    jxs, jte, jtr, _ = jmoe.group_tokens(j_bf16(x), jnp.asarray(top_idx), TM, E)
    txs, tte, ttr, _ = moe.group_tokens(t_bf16(x), torch.from_numpy(top_idx), TM, E)
    live_rows = np.repeat(ttr.numpy() > 0, TM)
    assert not live_rows.all() and not txs.float().numpy()[live_rows].all(axis=1).all()  # dead tiles, padding rows
    if elem is None:
        ref = jmoe.grouped_matmul(jxs, j_bf16(w), jte, jtr, tm=TM, bn=128, bk=128)
        got = moe.grouped_matmul(txs, t_bf16(w), tte, ttr, tm=TM)
    else:
        codes, scales = quantize_stacked(t_bf16(w), elem)
        j_codes = jnp.asarray(codes.numpy().view(np.int8 if elem == "int8" else np.uint8))
        ref = jmoe.grouped_matmul(jxs, j_codes, jte, jtr, tm=TM, bn=128, bk=128,
                                  w_scale=jnp.asarray(scales.numpy()), elem_name=elem)
        got = moe.grouped_matmul(txs, codes, tte, ttr, tm=TM, w_scale=scales, elem_name=elem)
    ref, got = np.asarray(ref, np.float32), got.float().numpy()
    assert within_bf16_steps(got, ref)
    dead = np.repeat(ttr.numpy() == 0, TM)
    assert not got[dead].any() and not ref[dead].any()


@pytest.mark.parametrize("elem", ["float8_e4m3", "float6_e3m2", "float6_e2m3", "float4_e2m1", "int8"])
def test_quantize_stacked_bytes_equal_jax(elem):
    """Codes (int8-domain re-coding for fp4 and e2m3) and scales byte for byte."""
    w = bf16(np.random.default_rng(3).standard_normal((3, 128, 64)) * 0.05)
    jq, js = JGrouped._quantize_stacked(j_bf16(w), elem)
    tq, ts = quantize_stacked(t_bf16(w), elem)
    assert tq.shape == (3, 128, 64) and ts.shape == (3, 4, 64)
    assert str(tq.dtype).split(".")[-1] == str(jq.dtype)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- the MoE blocks ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_block():
    return jmix.MixtralSparseMoeBlock(jmix.MixtralConfig(**TINY), rngs=nnx.Rngs(7))


MODES = {"dense": dict(), "capacity": dict(capacity_factor=0.5), "grouped": dict(grouped=True, grouped_tm=TM)}


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_block_matches_jax(jax_block, mode):
    blk = port_block(jax_block, tmix.MixtralConfig(**TINY))
    x = bf16(np.random.default_rng(7).standard_normal((2, 32, 128)))
    for k, v in {"capacity_factor": None, "grouped": False, "grouped_tm": 128, **MODES[mode]}.items():
        setattr(jax_block, k, v)
        setattr(blk, k, v)
    ref = np.asarray(jax_block(j_bf16(x)), np.float32)
    got = blk(t_bf16(x)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=4e-2, rtol=4e-2)


MX_BLOCKS = {"per-expert fp8": ("float8_e4m3", False), "grouped fp4": ("float4_e2m1", True),
             "grouped e3m2": ("float6_e3m2", True), "grouped int8": ("int8", True)}


@pytest.mark.parametrize("name", list(MX_BLOCKS))
def test_mx_blocks_match_jax(name):
    """The same bf16 block quantized by each package (fp8 activations); a
    JAX grouped block's bytes carried across by ``convert`` equal the
    port's own quantization."""
    elem, grouped = MX_BLOCKS[name]
    jblk = jmix.MixtralSparseMoeBlock(jmix.MixtralConfig(**TINY), rngs=nnx.Rngs(11))
    cfg = tmix.MixtralConfig(**TINY)
    blk = port_block(jblk, cfg)
    for b in (jblk, blk):
        b.grouped, b.grouped_tm = grouped, TM
    jq = JQLin(weights_config=JMXConfig(elem), activations_config=JMXConfig("float8_e4m3"))
    tq = QLinearConfig(MXConfig(elem), MXConfig("float8_e4m3"))
    jm, tm_ = JMX.from_float(jblk, jq), MXInferenceMixtralMoeBlock.from_float(blk, tq)
    assert type(tm_) is (MXInferenceMixtralMoeBlockGrouped if grouped else MXInferenceMixtralMoeBlock)
    if grouped:
        jm.grouped_tm = tm_.grouped_tm = TM
        assert tm_.kernel_elem == jm.kernel_elem
        bufs = {k: {n: np.asarray(getattr(jm, f"{n}_{k}").get_value()) for n in ("w1", "w3", "w2")}
                for k in ("codes", "scale")}
        carried = grouped_moe_from_buffers(cfg, np.asarray(jm.gate_weight.get_value()), bufs["codes"],
                                           bufs["scale"], tq, jm.kernel_elem, device="cpu")
        for n in ("w1", "w3", "w2"):
            for k in ("codes", "scale"):
                assert torch.equal(getattr(carried, f"{n}_{k}"), getattr(tm_, f"{n}_{k}"))
    x = bf16(np.random.default_rng(12).standard_normal((1, 24, 128)))
    ref = np.asarray(jm(j_bf16(x)), np.float32)
    got = tm_(t_bf16(x)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def test_grouped_int8_block_equals_per_expert_bitwise():
    """int8 weights, fp8 activations: the grouped block (K2 then plain B12)
    gives the per-expert block's (plain B6 with fused fq) bytes, at tm 8
    and 128."""
    cfg = tmix.MixtralConfig(**TINY)
    blk = tmix.MixtralSparseMoeBlock(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    q = QLinearConfig(MXConfig("int8"), MXConfig("float8_e4m3"))
    per_expert = MXInferenceMixtralMoeBlock.from_float(blk, q)
    blk.grouped = True
    grouped = MXInferenceMixtralMoeBlock.from_float(blk, q)
    x = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    want = per_expert(x)
    for tm in (TM, 128):
        grouped.grouped_tm = tm
        assert torch.equal(grouped(x), want)


# -- the model -------------------------------------------------------------------------------------


def test_quantized_mixtral_matches_jax():
    """2 layers, fp4 grouped experts, fp8 activations, int8 cache: the JAX
    model's bf16 weights through ``convert``, both quantized by their own
    ``quantize_llm_``; prefill of 8 and 3 greedy steps against the JAX
    Pallas path op by op."""
    cfg = dict(TINY, head_dim=128)
    jmodel = jmix.MixtralForCausalLM(jmix.MixtralConfig(**cfg), rngs=nnx.Rngs(0))
    port = from_flat_params(flat_state(jmodel), tmix.MixtralConfig(**cfg), device="cpu")
    assert type(port).__name__ == "MixtralForCausalLM"
    for m in (jmodel, port):
        for layer in m.model.layers:
            layer.mlp.grouped, layer.mlp.grouped_tm = True, TM
    jq = JQLin(weights_config=JMXConfig(FP4_FP8[0]), activations_config=JMXConfig(FP4_FP8[1]))
    jquantize_llm_(jmodel, JQAttn(projection_config=jq), jq)
    tq = QLinearConfig(MXConfig(FP4_FP8[0]), MXConfig(FP4_FP8[1]))
    quantize_llm_(port, QAttentionConfig(tq), tq)
    layer = port.model.layers[0]
    assert type(layer.mlp) is MXInferenceMixtralMoeBlockGrouped and layer.block_sparse_moe is layer.mlp
    assert type(layer.self_attn) is MXInferenceMistralAttention
    ids = np.random.default_rng(13).integers(0, 256, (2, 8)).astype(np.int32)
    n = 4
    old = jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
    try:
        caches = jmodel.init_cache(2, 128, JMXConfig("int8"))
        logits, caches = jmodel(jnp.asarray(ids), attention_mask=None, position_ids=jnp.arange(8)[None, :],
                                caches=caches, cache_position=0)
        ref = [np.asarray(logits[:, -1], np.float32)]
        for i in range(n - 1):
            tok = jnp.asarray(ref[-1].argmax(-1)[:, None], jnp.int32)
            logits, caches = jmodel(tok, attention_mask=None, position_ids=jnp.full((2, 1), 8 + i, jnp.int32),
                                    caches=caches, cache_position=8 + i)
            ref.append(np.asarray(logits[:, -1], np.float32))
    finally:
        jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = old
    ref = np.stack(ref, axis=1)
    got, got_logits = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig("int8"), return_logits=True)
    got, got_logits = got.numpy(), got_logits.numpy()
    for row in range(2):
        for i in range(n):
            r = float(np.abs(got_logits[row, i] - ref[row, i]).max() / np.abs(ref[row, i]).max())
            print(f"row {row} step {i}: logits rel {r:.3e}")
            assert r <= 2e-2
            top2 = np.sort(ref[row, i])[-2:]
            if got[row, i] != ref[row, i].argmax():
                assert top2[1] - top2[0] < 0.1, f"row {row} step {i}: tokens differ at gap {top2[1] - top2[0]}"
                break
    assert sum(cuda_lib.LAUNCHES.values()) == 0


@pytest.fixture(scope="module")
def tiny_port():
    """The port's own 2-layer fp4 grouped Mixtral, built layer by layer."""
    q = QLinearConfig(MXConfig(FP4_FP8[0]), MXConfig(FP4_FP8[1]))

    def grouped(layer):
        layer.mlp.grouped, layer.mlp.grouped_tm = True, TM

    return build_quantized(tmix.MixtralForCausalLM, tmix.MixtralConfig(**dict(TINY, head_dim=128)),
                           QAttentionConfig(q), q, "cpu", torch.Generator().manual_seed(0), prepare_layer=grouped)


def test_engine_stream_on_mixtral(tiny_port):
    """``DecodeEngine`` over the int8 cache: three requests staggered among
    four slots give ``generate``'s greedy tokens, bit for bit."""
    assert type(tiny_port.model.layers[1].mlp) is MXInferenceMixtralMoeBlockGrouped
    kv = MXConfig("int8")
    prompts = [np.random.default_rng(20 + i).integers(0, 256, n).tolist() for i, n in enumerate((9, 17, 5))]
    want = [generate(tiny_port, torch.tensor([p]), 6, kv_cache_config=kv)[0].tolist() for p in prompts]
    eng = DecodeEngine(tiny_port, 4, 64, kv_cache_config=kv, device="cpu")
    got, slots = {}, {}
    for i, p in enumerate(prompts):
        slots[eng.add(p)] = i
        got[i] = []
        for tok_slot, tok in eng.step().items():
            got[slots[tok_slot]].append(tok)
    while any(len(v) < 6 for v in got.values()):
        for tok_slot, tok in eng.step().items():
            got[slots[tok_slot]].append(tok)
    assert [got[i][:6] for i in range(3)] == want


def test_mistral_window_raises_and_registry():
    """A Mistral layer with a sliding window raises when built; without one
    it builds, and the registry maps each family's blocks to their MX
    types; the per-expert block's grouped seam raises with the JAX
    package's message; the router stays a bf16 tensor."""
    small = dict(vocab_size=64, hidden_size=128, intermediate_size=256, num_hidden_layers=1,
                 num_attention_heads=1, num_key_value_heads=1)
    with pytest.raises(NotImplementedError, match="sliding"):
        MistralForCausalLM(MistralConfig(**small), device="cpu")
    model = MistralForCausalLM(MistralConfig(**small, sliding_window=None), device="cpu")
    q = QLinearConfig(MXConfig("float8_e4m3"), MXConfig("float8_e4m3"))
    quantize_llm_(model, QAttentionConfig(q), q)
    layer = model.model.layers[0]
    assert type(layer.self_attn).__name__ == "MXInferenceMistralAttention"
    assert type(layer.mlp).__name__ == "MXInferenceMistralMLP"
    moe_model = tmix.MixtralForCausalLM(tmix.MixtralConfig(**dict(TINY, num_hidden_layers=1)), device="cpu")
    quantize_llm_(moe_model, QAttentionConfig(q), q)
    blk = moe_model.model.layers[0].mlp
    assert type(blk) is MXInferenceMixtralMoeBlock
    assert isinstance(blk.gate_weight, torch.Tensor) and blk.gate_weight.dtype == torch.bfloat16
    assert not any("gate" in name for name, _ in blk.named_modules())
    with pytest.raises(NotImplementedError, match="grouped"):
        blk._expert_ffn_grouped(None, None, None, TM)


def test_grouped_wrapper_raises_on_what_the_kernel_does_not_take():
    x = torch.zeros(16, 128, dtype=torch.bfloat16)
    te, tr = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    w = torch.zeros(2, 128, 64, dtype=torch.uint8)
    s = torch.zeros(2, 4, 64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of tm"):
        cuda_moe.mx_grouped_matmul(x[:12], w, te, tr, 8, s, "float8_e4m3")
    with pytest.raises(ValueError, match="int8"):
        cuda_moe.mx_grouped_matmul(x, w, te, tr, 8, s, "int8")
    with pytest.raises(ValueError, match="w_scale"):
        cuda_moe.mx_grouped_matmul(x, w, te, tr, 8, None, "float8_e4m3")
    with pytest.raises(ValueError, match="tile_expert"):
        cuda_moe.mx_grouped_matmul(x, w, te.long(), tr, 8, s, "float8_e4m3")


# -- the CUDA kernel (needs a card) ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 5, 17, 300])
def test_cuda_router_kernel_is_row_invariant(cuda_device, rows):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(512, 4096, generator=g).to(torch.bfloat16).to(cuda_device)
    w = (torch.randn(8, 4096, generator=g) * 4096 ** -0.5).to(torch.bfloat16).to(cuda_device)
    full = cuda_moe.mx_router_logits(x, w)
    assert torch.equal(cuda_moe.mx_router_logits(x[:rows], w), full[:rows])
    assert within_bf16_steps(full.float().cpu().numpy(), cuda_moe.mx_router_logits_plain(x, w).float().cpu().numpy())
