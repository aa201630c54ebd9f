"""The port's MX linear for every non-fp4 weight layout, held against the JAX
package on the same numpy inputs: the weight layouts (MXFP8 halves, MXFP6
quarters, the exact int8 domain) byte for byte, the layout each
``MXInferenceLinear`` picks, the dispatch of ``mx_dynamic_matmul`` / ``mx_matmul``,
the plain versions of B6 ``mx_matmul_1byte``, B8 ``mx_matmul_fp6q``, B9
``mx_matmul_int8dot`` and K3 over fp8 halves against the Pallas kernels they
replace (interpret mode), and a 2-layer model per configuration (W8A8 over an
int8 cache, MXFP6 and MXFP8 weights over an fp8 cache) against the JAX model.
On a machine with a card, the CUDA kernels against their plain versions.

Tolerances: layouts and layout choice bit-exact; B6, B8 and K3 rel <= 1e-2
(max abs difference over max abs output: the fp32 accumulation order
differs); B9 rtol / atol 1e-2, as the JAX package's own int8-dot tests
(exact block sums, f32 reordering across blocks); the model's logits rel
<= 2e-2 and greedy tokens equal up to the first JAX top-2 gap below 0.1, as
``tests/test_torch_llama.py``.  On the card: B6, B8 and K3-fp8 rel <= 1e-2,
B9 within one bf16 step of its plain version, RMSNorm within one bf16 step.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.config import MXConfig as JMXConfig
from torchmx_tpu.config import QAttentionConfig as JQAttn
from torchmx_tpu.config import QLinearConfig as JQLin
from torchmx_tpu.layers.linear import MXInferenceLinear as JLinear
from torchmx_tpu.models.llama import LlamaConfig as JLlamaConfig
from torchmx_tpu.models.llama import LlamaForCausalLM as JLlama
from torchmx_tpu.mx_array import MXArray
from torchmx_tpu.ops import matmul as jmm
from torchmx_tpu.ops import pallas_matmul as jpm
from torchmx_tpu.quant_api import quantize_llm_ as jquantize_llm_
from torchmx_tpu_torch import env_variables as tenv
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.convert import from_flat_params, mx_tensor_from_buffers
from torchmx_tpu_torch.layers.linear import MXInferenceLinear
from torchmx_tpu_torch.models.generate import generate
from torchmx_tpu_torch.models.llama import LlamaConfig
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_lib, cuda_matmul, cuda_matmul_formats as kf
from torchmx_tpu_torch.ops import matmul as tmm
from torchmx_tpu_torch.quant_api import quantize_llm_

torch.set_num_threads(1)

KNOBS = ("TORCHMX_FP6_PACK", "TORCHMX_FP8_HALVES", "TORCHMX_FP8_DOT", "TORCHMX_INT8_DOMAIN")


@contextlib.contextmanager
def knobs(**kw):
    """Set layout / dispatch knobs on both packages' env modules."""
    old = {k: (getattr(jenv, k), getattr(tenv, k)) for k in KNOBS}
    for k, v in kw.items():
        setattr(jenv, k, v)
        setattr(tenv, k, v)
    try:
        yield
    finally:
        for k, (j, t) in old.items():
            setattr(jenv, k, j)
            setattr(tenv, k, t)


def rand_bf16(seed, shape, spread=1.0, scale=1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * spread) * scale
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def weight_pair(seed, K, N, elem, scale=0.05):
    """The same bf16 weight (N, K) quantized K-major by both packages."""
    w = rand_bf16(seed, (N, K), spread=0.5, scale=scale)
    return MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), elem, 32).T, MXTensor.to_mx(to_torch(w), elem, 32).T


def same_bytes(t: MXTensor, j: MXArray):
    np.testing.assert_array_equal(t.data.numpy().view(np.uint8), np.asarray(j.data).view(np.uint8))
    np.testing.assert_array_equal(t.scale_e8m0.numpy(), np.asarray(j.scale_e8m0))
    assert t.elem_dtype.name == j.elem_dtype.name and t.fp4_pack == j.fp4_pack
    assert str(t.data.dtype).split(".")[-1] == str(j.data.dtype)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- layouts -----------------------------------------------------------------------

LAYOUTS = [("float8_e4m3", "to_fp8_halves"), ("float6_e3m2", "to_fp6_quarters"),
           ("float6_e2m3", "to_fp6_quarters"), ("float4_e2m1", "to_int8_domain"),
           ("float6_e2m3", "to_int8_domain"), ("int8", "to_int8_domain")]


@pytest.mark.parametrize("elem,method", LAYOUTS, ids=[f"{e}-{m}" for e, m in LAYOUTS])
def test_layout_bytes_equal_jax(elem, method):
    """Each repacking gives JAX's bytes, and dequantizes to JAX's values."""
    jw, tw = weight_pair(1, 512, 128, elem)
    jk, tk = getattr(jw, method)(), getattr(tw, method)()
    same_bytes(tk, jk)
    assert tk.shape == tuple(jk.shape)
    np.testing.assert_array_equal(tk.to_dtype(torch.float32).numpy(), np.asarray(jk.to_dtype(jnp.float32)))
    if method != "to_int8_domain":  # the inverse repacks to the flat bytes
        inverse = tk._fp8_halves_to_flat() if elem == "float8_e4m3" else tk._quarters_to_flat()
        same_bytes(inverse, jw)


def test_int8_domain_of_fp4_halves_and_the_flush_contract():
    """fp4 halves re-code through the pair layout; a block whose scale is
    below k (1 for fp4) flushes to zero, as ``mx_array.py:581-586``."""
    jw, tw = weight_pair(2, 256, 128, "float4_e2m1")
    scale = np.asarray(jw.scale_e8m0).copy()
    scale[0, :4] = 0
    jw = MXArray(jnp.asarray(scale), jw.data, jw.elem_dtype, 32, jw.orig_dtype, 0, 0)
    tw = tw._replace(scale_e8m0=torch.from_numpy(scale))
    same_bytes(tw.to_fp4_halves().to_int8_domain(), jw.to_fp4_halves().to_int8_domain())
    assert int(tw.to_int8_domain().data[:32, :4].abs().sum()) == 0
    with pytest.raises(ValueError):
        weight_pair(3, 256, 128, "float8_e4m3")[1].to_int8_domain()


def test_mx_tensor_from_jax_buffers():
    """``convert.mx_tensor_from_buffers`` carries a JAX weight across in
    every layout (uint16 fp8 halves included)."""
    for elem, method in (("float8_e4m3", "to_fp8_halves"), ("float6_e3m2", "to_fp6_quarters"),
                         ("int8", "to_int8_domain")):
        jw = getattr(weight_pair(4, 1024, 64, elem)[0], method)()
        t = mx_tensor_from_buffers(np.asarray(jw.data), np.asarray(jw.scale_e8m0), jw.elem_dtype.name,
                                   jw.fp4_pack, block_dim=0, device="cpu")
        same_bytes(t, jw)


# -- the layout MXInferenceLinear picks ------------------------------------------

CHOICES = [  # (weights, K, knobs, expected layout)
    ("float4_e2m1", 512, {}, "halves"),
    ("float8_e4m3", 512, {}, "halves"),
    ("float8_e4m3", 512, {"TORCHMX_FP8_DOT": "1"}, "pair"),
    ("float8_e4m3", 512, {"TORCHMX_FP8_HALVES": "0"}, "pair"),
    ("float8_e4m3", 256, {}, "pair"),
    ("float8_e4m3-tiny", 512, {}, "pair"),
    ("float6_e3m2", 1024, {}, "quarters"),
    ("float6_e2m3", 1024, {}, "quarters"),
    ("float6_e3m2", 1024, {"TORCHMX_FP6_PACK": "0"}, "pair"),
    ("float6_e3m2", 512, {}, "pair"),
    ("float4_e2m1", 512, {"TORCHMX_INT8_DOMAIN": "1"}, "pair"),
    ("float6_e2m3", 1024, {"TORCHMX_INT8_DOMAIN": "1"}, "pair"),
    ("int8", 512, {}, "pair"),
]


@pytest.mark.parametrize("weights,K,kw,layout", CHOICES,
                         ids=[f"{w}-K{k}-{'-'.join(f'{a}={b}' for a, b in kw.items()) or 'default'}"
                              for w, k, kw, _ in CHOICES])
def test_linear_picks_the_layout_jax_picks(weights, K, kw, layout):
    """Same bytes, format and layout as JAX's ``MXInferenceLinear`` for the
    same weight and knobs (``float8_e4m3-tiny``: block scales below 10, which
    keep the flat layout)."""
    elem = weights.removesuffix("-tiny")
    w = rand_bf16(5, (128, K), spread=0.5, scale=2.0 ** -118 if weights.endswith("tiny") else 0.05)
    jq = JQLin(weights_config=JMXConfig(elem), activations_config=JMXConfig("float8_e4m3"))
    tq = QLinearConfig(MXConfig(elem), MXConfig("float8_e4m3"))
    with knobs(**kw):
        jl = JLinear.from_weights(jnp.asarray(w, jnp.bfloat16), None, jq)
        tl = MXInferenceLinear(MXTensor.to_mx(to_torch(w), elem, 32), None, tq)
    jw = jl.weight.get_value()
    same_bytes(tl.weight, jw)
    assert tl.weight.fp4_pack == layout
    assert (tl.in_features, tl.out_features) == (jl.in_features, jl.out_features)


# -- dispatch ------------------------------------------------------------------------


@contextlib.contextmanager
def spies(calls):
    """Record which kernel (and fused activation format) each matmul of both
    packages goes to, returning zeros."""
    def port(name, arg):
        def f(x, *a):
            calls.append(("port", name, a[arg] if arg is not None and arg < len(a) else None))
            return torch.zeros(x.shape[0], a[0].shape[-1], dtype=torch.bfloat16)
        return f

    def jax_(name, act_arg):
        def f(x, w, *a, **k):
            act = k.get("act_fq", a[act_arg] if len(a) > act_arg else None) if act_arg is not None else k.get("fp8", False)
            calls.append(("jax", name, act))
            if name == "int8dot":  # (xc.T, sx.T, w codes, w scales, ...)
                return jnp.zeros((x.shape[1], a[0].shape[1]), jnp.bfloat16)
            return jnp.zeros((x.shape[0], w.shape[1]), jnp.bfloat16)
        return f

    patches = [(kf, "mx_matmul_1byte", port("1byte", 3)), (kf, "mx_matmul_fp6q", port("fp6q", 3)),
               (kf, "mx_matmul_int8dot", port("int8dot", 2)),
               (cuda_matmul, "mx_matmul_fp8_halves", port("halves", 2)),
               (jpm, "_pallas_matmul_1byte", jax_("1byte", 5)), (jpm, "_pallas_matmul_fp6q", jax_("fp6q", 5)),
               (jpm, "_pallas_matmul_int8dot", jax_("int8dot", None)),
               (jpm, "_pallas_matmul_fp4_halves", jax_("halves", 4))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    old_backend = jenv.TORCHMX_QUANTIZE_BACKEND
    jenv.TORCHMX_QUANTIZE_BACKEND = "pallas"
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        jenv.TORCHMX_QUANTIZE_BACKEND = old_backend
        for m, n, f in saved:
            setattr(m, n, f)


DISPATCH = [  # (weights, activations, knobs)
    ("int8", "int8", {}), ("float8_e4m3", "float8_e4m3", {"TORCHMX_FP8_DOT": "1"}),
    ("float8_e4m3", "float8_e4m3", {}), ("float6_e3m2", "float8_e4m3", {}),
    ("float4_e2m1", "int8", {"TORCHMX_INT8_DOMAIN": "1"}),
]


@pytest.mark.parametrize("M", [64, 65, 256, 257])
@pytest.mark.parametrize("weights,acts,kw", DISPATCH,
                         ids=[f"{w}-{a}{'-dot' if k else ''}" for w, a, k in DISPATCH])
def test_dispatch_matches_jax(weights, acts, kw, M):
    """``mx_dynamic_matmul`` and ``mx_matmul`` send a call to the kernel JAX
    sends it to, at both sides of M = 64 and M = 256: B9 for int8 (or, under
    ``TORCHMX_FP8_DOT``, fp8) activations at M <= 256, else the weight
    layout's kernel; the port fuses the activation quantize wherever that
    kernel takes the format."""
    K, N = 1024, 256
    x = rand_bf16(6, (M, K))
    elem = weights
    jq = JQLin(weights_config=JMXConfig(elem), activations_config=JMXConfig(acts))
    tq = QLinearConfig(MXConfig(elem), MXConfig(acts))
    w = rand_bf16(7, (N, K), spread=0.5, scale=0.05)
    calls = []
    with knobs(**kw):
        jl = JLinear.from_weights(jnp.asarray(w, jnp.bfloat16), None, jq)
        tl = MXInferenceLinear(MXTensor.to_mx(to_torch(w), elem, 32), None, tq)
        with spies(calls):
            jmm.mx_dynamic_matmul(jnp.asarray(x, jnp.bfloat16), jl.weight.get_value(), acts, 32)
            jmm.mx_matmul(jnp.asarray(x, jnp.bfloat16), jl.weight.get_value())
            tmm.mx_dynamic_matmul(to_torch(x), tl.weight, acts)
            tmm.mx_matmul(to_torch(x), tl.weight)
    jax_calls = [c[1] for c in calls if c[0] == "jax"]
    port_calls = [c for c in calls if c[0] == "port"]
    assert [c[1] for c in port_calls] == jax_calls, calls
    dot = acts == "int8" or kw.get("TORCHMX_FP8_DOT") == "1"
    assert port_calls[0][1] == ("int8dot" if dot and M <= 256 else port_calls[1][1])
    if port_calls[0][1] != "int8dot":
        assert port_calls[0][2] == acts and port_calls[1][2] is None


def test_w8a8_mlp_takes_b6_without_act_above_64_rows(monkeypatch):
    """The two-pass form at prefill (``shared_activation_fq``, M > 64): gate
    and up read x fake-quantized once and run B6 without ``act_fq``, while
    down_proj goes to B9 up to 256 rows; at 64 rows all three go to B9."""
    from torchmx_tpu_torch.layers.mx_llama_attention import MXInferenceLlamaMLP
    from torchmx_tpu_torch.models.llama import LlamaConfig as TCfg, LlamaMLP

    cfg = TCfg(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=1,
               num_attention_heads=2, num_key_value_heads=1, head_dim=128)
    q = QLinearConfig(MXConfig("int8"), MXConfig("int8"))
    mlp = MXInferenceLlamaMLP.from_float(LlamaMLP(cfg, "cpu", torch.Generator().manual_seed(0)), q)
    for M, want in ((64, ["int8dot"] * 3), (65, ["1byte", "1byte", "int8dot"]), (300, ["1byte"] * 3)):
        calls = []
        with spies(calls):
            mlp(torch.randn(1, M, 256).to(torch.bfloat16))
        assert [c[1] for c in calls] == want, (M, calls)
        if M == 300:
            assert [c[2] for c in calls] == [None, None, "int8"]


@pytest.mark.parametrize("M", [1, 32, 64, 65])
def test_fp6q_layers_share_one_activation_quantize_at_every_m(M):
    """B8's wrapper quantizes x by K2 first at every M, so with fp6-quarters
    weights the layers fake-quantize x once for q/k/v and once for gate/up
    at every M (``shared_activation_fq``), and those B8 calls take no
    ``act_fq``; down_proj's stays.  The outputs are bit-identical to each
    linear quantizing its own x."""
    from torchmx_tpu_torch.layers.linear import shared_activation_fq
    from torchmx_tpu_torch.layers.mx_llama_attention import MXInferenceLlamaAttention, MXInferenceLlamaMLP
    from torchmx_tpu_torch.models.llama import LlamaAttention, LlamaConfig as TCfg, LlamaMLP, silu

    cfg = TCfg(vocab_size=64, hidden_size=1024, intermediate_size=1024, num_hidden_layers=1,
               num_attention_heads=8, num_key_value_heads=2, head_dim=128)
    q = QLinearConfig(MXConfig("float6_e3m2"), MXConfig("float8_e4m3"))
    gen = torch.Generator().manual_seed(0)
    mlp = MXInferenceLlamaMLP.from_float(LlamaMLP(cfg, "cpu", gen), q)
    attn = MXInferenceLlamaAttention.from_float(LlamaAttention(cfg, 0, "cpu", gen), QAttentionConfig(q))
    assert mlp.gate_proj.weight.fp4_pack == "quarters"
    x = torch.randn(1, M, 1024, generator=gen).to(torch.bfloat16)
    calls = []
    with spies(calls):
        mlp(x)
        attn._project_qkv(x)
    assert [c[1:] for c in calls] == ([("fp6q", None)] * 2 + [("fp6q", "float8_e4m3")] + [("fp6q", None)] * 3)
    assert shared_activation_fq(x, mlp.gate_proj, mlp.up_proj) is not None
    h = silu(mlp.gate_proj(x)) * mlp.up_proj(x)
    assert torch.equal(mlp(x), mlp.down_proj(h))
    for got, lin in zip(attn._project_qkv(x), (attn.q_proj, attn.k_proj, attn.v_proj)):
        assert torch.equal(got, lin(x))


@pytest.fixture(scope="module")
def fp4_layer_pair():
    """Layer 0 of the 2-layer model (hidden 512, intermediate 1024) from the
    same bf16 weights, quantized to MXFP4 weights / MXFP8 activations by
    each package: (JAX layer, port layer)."""
    jmodel = JLlama(JLlamaConfig(**SMALL), rngs=nnx.Rngs(3))
    _, state = nnx.split(jmodel)
    params = {".".join(map(str, k)): np.asarray(v.get_value()) for k, v in state.flat_state()}
    port = from_flat_params(params, LlamaConfig(**SMALL), device="cpu")
    jq = JQLin(weights_config=JMXConfig("float4_e2m1"), activations_config=JMXConfig("float8_e4m3"))
    jquantize_llm_(jmodel, JQAttn(projection_config=jq), jq)
    tq = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    quantize_llm_(port, QAttentionConfig(tq), tq)
    return jmodel.model.layers[0], port.model.layers[0]


@pytest.mark.parametrize("M", [1, 32, 64, 2048])
def test_fp4_layers_share_one_activation_quantize_at_every_m(fp4_layer_pair, M):
    """K3's wrappers quantize x by K2 first at every M, so with fp4 halves
    weights the layers fake-quantize x once for q/k/v and once for gate/up
    at every M (two K2 launches on the card), and those K3 calls take no
    ``act_fq``; down_proj's wrapper takes its own.  The MLP's output and the
    q/k/v projections equal the JAX layer's (Pallas path, interpret mode):
    rel <= 1e-2 for a projection, 2e-2 for the MLP (down_proj's activation
    quantize turns an ulp of its input into a quantization step), as
    ``tests/test_torch_llama.py``'s logits."""
    from torchmx_tpu_torch.layers import linear

    jlayer, layer = fp4_layer_pair
    mlp, attn = layer.mlp, layer.self_attn
    assert {lin.weight.fp4_pack for lin in (mlp.gate_proj, mlp.down_proj, attn.q_proj, attn.o_proj)} == {"halves"}
    x = rand_bf16(30 + M, (1, M, SMALL["hidden_size"]))
    calls, k2 = [], []
    k3, fq = cuda_matmul.mx_matmul_fp4_halves, linear.mx_fake_quantize

    def spy_k3(x2, w, s, act_fq=None):
        calls.append(act_fq)
        return k3(x2, w, s, act_fq)

    def spy_fq(*a, **k):
        k2.append(a[0].shape)
        return fq(*a, **k)

    cuda_matmul.mx_matmul_fp4_halves, linear.mx_fake_quantize = spy_k3, spy_fq
    try:
        got_mlp = mlp(to_torch(x))
        got_qkv = attn._project_qkv(to_torch(x))
    finally:
        cuda_matmul.mx_matmul_fp4_halves, linear.mx_fake_quantize = k3, fq
    assert calls == [None, None, "float8_e4m3", None, None, None]
    assert len(k2) == 2
    old = jenv.TORCHMX_QUANTIZE_BACKEND
    jenv.TORCHMX_QUANTIZE_BACKEND = "pallas"
    try:
        xj = jnp.asarray(x, jnp.bfloat16)
        ref_mlp = jlayer.mlp(xj)
        ref_qkv = [jlayer.self_attn.q_proj(xj), jlayer.self_attn.k_proj(xj), jlayer.self_attn.v_proj(xj)]
    finally:
        jenv.TORCHMX_QUANTIZE_BACKEND = old
    assert rel(got_mlp.float().numpy(), ref_mlp) <= 2e-2
    for got, ref in zip(got_qkv, ref_qkv):
        assert rel(got.float().numpy(), ref) <= 1e-2
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- the kernels' plain versions against the Pallas kernels -----------------------------------


@pytest.mark.parametrize("act_fq", [None, "float8_e4m3", "int8"])
@pytest.mark.parametrize("elem", kf.CODE_FORMATS_1BYTE)
def test_1byte_plain_matches_pallas_kernel(elem, act_fq):
    M, K, N = 16, 256, 128
    x = rand_bf16(8, (M, K))
    jw, tw = weight_pair(9, K, N, elem)
    ref = jpm._pallas_matmul_1byte(jnp.asarray(x, jnp.bfloat16), jw.data, jw.scale_e8m0, elem, N, K,
                                   jnp.bfloat16, act_fq)
    got = kf.mx_matmul_1byte(to_torch(x), tw.data, tw.scale_e8m0, elem, act_fq)
    assert rel(got.float().numpy(), ref) <= 1e-2


@pytest.mark.parametrize("act_fq", [None, "float8_e4m3"])
@pytest.mark.parametrize("elem", kf.FP6_FORMATS)
def test_fp6q_plain_matches_pallas_kernel(elem, act_fq):
    M, K, N = 16, 512, 128
    x = rand_bf16(10, (M, K))
    jw, tw = weight_pair(11, K, N, elem)
    jw, tw = jw.to_fp6_quarters(), tw.to_fp6_quarters()
    ref = jpm._pallas_matmul_fp6q(jnp.asarray(x, jnp.bfloat16), jw.data, jw.scale_e8m0, elem, N, K,
                                  jnp.bfloat16, act_fq)
    got = kf.mx_matmul_fp6q(to_torch(x), tw.data, tw.scale_e8m0, elem, act_fq)
    assert rel(got.float().numpy(), ref) <= 1e-2


@pytest.mark.parametrize("act_fq", [None, "float8_e4m3"])
def test_fp8_halves_plain_matches_pallas_kernel(act_fq):
    M, K, N = 16, 512, 128
    x = rand_bf16(12, (M, K))
    jw, tw = weight_pair(13, K, N, "float8_e4m3")
    jw, tw = jw.to_fp8_halves(), tw.to_fp8_halves()
    ref = jpm._pallas_matmul_fp4_halves(jnp.asarray(x, jnp.bfloat16), jw.data, jw.scale_e8m0, N, K,
                                        jnp.bfloat16, act_fq, elem_name="float8_e4m3")
    got = cuda_matmul.mx_matmul_fp8_halves(to_torch(x), tw.data, tw.scale_e8m0, act_fq)
    assert rel(got.float().numpy(), ref) <= 1e-2
    # the dot-operand decode equals the dequantized weight wherever it is bf16-normal
    np.testing.assert_array_equal(cuda_matmul.dequantize_fp8_halves(tw.data, tw.scale_e8m0).float().numpy(),
                                  tw.to_dtype(torch.float32).numpy())


@pytest.mark.parametrize("src", ["int8", "float4_e2m1", "float6_e2m3", "float8_e4m3"])
def test_int8dot_plain_matches_pallas_kernel(src):
    """B9 on int8 weights, int8-domain fp4 / e2m3 weights (int8 activations)
    and fp8 weights (fp8 activations)."""
    M, K, N = 8, 512, 256
    x = rand_bf16(14, (M, K))
    jw, tw = weight_pair(15, K, N, src)
    fp8 = src == "float8_e4m3"
    if not fp8:
        jw, tw = jw.to_int8_domain(), tw.to_int8_domain()
    run = jpm.fp8dot_any if fp8 else jpm.int8dot_any
    ref = np.asarray(run(jnp.asarray(x, jnp.bfloat16), jw, jnp.bfloat16), np.float32)
    got = kf.mx_matmul_int8dot(to_torch(x), tw.data, tw.scale_e8m0, fp8).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)


def test_b9_and_b6_agree_on_int8_rows():
    """For int8 weights and an int8-grid x every block's partial is exact, so
    the plain B9 and the plain B6 with int8 ``act_fq`` agree (f32
    reordering only), and B9 equals the dequantize-then-dot reference."""
    x = to_torch(rand_bf16(16, (32, 512)))
    _, tw = weight_pair(17, 512, 128, "int8")
    b9 = kf.mx_matmul_int8dot(x, tw.data, tw.scale_e8m0).float()
    b6 = kf.mx_matmul_1byte(x, tw.data, tw.scale_e8m0, "int8", "int8").float()
    assert rel(b9.numpy(), b6.numpy()) <= 1e-2
    assert int((b9 != b6).sum()) <= b9.numel() // 100


# (N, K) of the main path's B6 calls: q/o, k/v, gate/up, down, lm_head.
B6_MAIN_NK = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256, 4096)]


@pytest.mark.parametrize("N,K", B6_MAIN_NK)
def test_b6_plan_fits_and_keeps_the_splits(N, K):
    """B6's launch plan over M = 1..4096 on a 132-SM card: the K splits are
    ``k_splits(N, K)``'s (shared with B9 and B12) at every M, the tiles are
    the same at every M, the shared memory fits a block and the column tile
    divides N."""
    want = {cuda_matmul.k_splits(N, K, 132)}
    plans = [kf.plan_1byte(M, N, K, 132) for M in range(1, 4097)]
    assert {p.splits for p in plans} == want
    assert {(p.bm, p.bn, p.stages) for p in plans} == {(kf.B6_BM, kf.B6_BN, kf.B6_STAGES)}
    assert all(p.smem_bytes <= kf.SMEM_LIMIT and N % p.bn == 0 for p in plans)
    assert all(not p.walk for p in plans if p.splits == 1)


@pytest.mark.parametrize("N,K", B6_MAIN_NK)
def test_b8_plan_fits_and_keeps_the_splits(N, K):
    """B8's launch plan over M = 1..4096 on a 132-SM card: the K splits are
    ``k_splits(N, K, 132, 128)`` at every M, the tile and the stage count are
    the same at every M, the shared memory fits a block and the column tile
    divides N."""
    plans = [kf.plan_fp6q(M, N, K, 132) for M in range(1, 4097)]
    assert {p.splits for p in plans} == {cuda_matmul.k_splits(N, K, 132, 128)}
    assert {(p.bm, p.bn, p.stages) for p in plans} == {(kf.B8_BM, kf.B8_BN, kf.B8_STAGES)}
    assert all(p.smem_bytes <= kf.SMEM_LIMIT and N % p.bn == 0 for p in plans)
    assert all(not p.walk for p in plans if p.splits == 1)


# (N, K) of K3's calls: Llama-3-8B's five linears (above), Mixtral-8x7B's
# q/o, k/v and lm_head, Moonlight-16B-A3B's q_proj, kv_a_proj (N = 576, a
# multiple of 64 but not of 128), o_proj, dense gate/up and down, shared
# experts' gate/up and lm_head, and the K = 512 of the 2-layer test models.
K3_MAIN_NK = B6_MAIN_NK + [(32000, 4096), (3072, 2048), (576, 2048), (2048, 2048), (11264, 2048), (2048, 11264),
                           (2816, 2048), (163840, 2048), (1024, 512), (512, 512)]


@pytest.mark.parametrize("elem", list(cuda_matmul.HALVES_FORMATS))
@pytest.mark.parametrize("N,K", K3_MAIN_NK)
def test_k3_plan_fits_and_keeps_the_splits(N, K, elem):
    """K3's launch plan over M = 1..4096 on a 132-SM card, for fp4 and fp8
    halves: the K splits are ``k_splits(N, K, 132, 128)`` at every M, the
    tile and the stage count are the same at every M, the shared memory fits
    a block."""
    plans = [cuda_matmul.plan_halves(M, N, K, 132, elem) for M in range(1, 4097)]
    splits = cuda_matmul.k_splits(N, K, 132, 128)
    assert {p.splits for p in plans} == {splits}
    assert {(p.bm, p.bn, p.stages) for p in plans} == {(cuda_matmul.K3_BM, cuda_matmul.K3_BN, cuda_matmul.K3_STAGES)}
    assert all(p.smem_bytes <= kf.SMEM_LIMIT and N % 64 == 0 for p in plans)
    assert all(not p.walk for p in plans if p.splits == 1)


def test_k3_plan_counts_the_shared_memory_of_each_format():
    """fp8 halves hold twice fp4's W bytes a stage; both leave room for no
    fourth stage, so the ring depth is the same for both."""
    fp4, fp8 = (cuda_matmul.k3_smem_bytes(e) for e in ("float4_e2m1", "float8_e4m3"))
    assert fp8 - fp4 == cuda_matmul.K3_STAGES * 64 * cuda_matmul.K3_BN
    stage = 2 * cuda_matmul.K3_BM * 128 + 64 * cuda_matmul.K3_BN + 4 * cuda_matmul.K3_BN
    assert fp4 <= kf.SMEM_LIMIT < fp4 + stage


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    _, tw = weight_pair(18, 256, 128, "float8_e4m3")
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="act_fq"):
        kf.mx_matmul_1byte(x, tw.data, tw.scale_e8m0, "float8_e4m3", "float6_e3m2")
    with pytest.raises(ValueError, match="code formats"):
        kf.mx_matmul_fp6q(x, tw.data, tw.scale_e8m0, "float8_e4m3")
    with pytest.raises(ValueError, match="act_fq"):
        cuda_matmul.mx_matmul_fp8_halves(x, tw.data, tw.scale_e8m0, "int8")
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- the slice: 2-layer models against the JAX model -------------------------------------

SMALL = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=128)
MODELS = {  # name -> (weights, activations, KV cache, knobs)
    "w8a8-int8kv": ("int8", "int8", "int8", {}),
    "fp6e3m2-fp8a-fp8kv": ("float6_e3m2", "float8_e4m3", "float8_e4m3", {}),
    "fp8-fp8a-fp8kv": ("float8_e4m3", "float8_e4m3", "float8_e4m3", {}),
    "fp8dot-fp8a-fp8kv": ("float8_e4m3", "float8_e4m3", "float8_e4m3", {"TORCHMX_FP8_DOT": "1"}),
}
TIE_GAP = 0.1


@pytest.fixture(scope="module")
def bf16_params():
    jmodel = JLlama(JLlamaConfig(**SMALL), rngs=nnx.Rngs(0))
    _, state = nnx.split(jmodel)
    return {".".join(map(str, k)): np.asarray(v.get_value()) for k, v in state.flat_state()}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_greedy_matches_jax(bf16_params, name):
    """Greedy decoding of 5 tokens from the same bf16 weights quantized by
    each package: the logits of every step at which the tokens still agree
    within 2e-2 of JAX's (Pallas path, op by op), and the tokens equal up to
    JAX's first near tie.  The layouts are the 8B model's: q/k/v/o, gate/up
    take K = 512 and down_proj K = 1024 (fp8 halves everywhere, fp6 quarters
    for down_proj only)."""
    weights, acts, kv, kw = MODELS[name]
    ids = np.random.default_rng(21).integers(0, SMALL["vocab_size"], size=(2, 8)).astype(np.int32)
    n = 5
    with knobs(**kw):
        jmodel = JLlama(JLlamaConfig(**SMALL), rngs=nnx.Rngs(0))
        port = from_flat_params(bf16_params, LlamaConfig(**SMALL), device="cpu")
        jq = JQLin(weights_config=JMXConfig(weights), activations_config=JMXConfig(acts))
        jquantize_llm_(jmodel, JQAttn(projection_config=jq), jq)
        tq = QLinearConfig(MXConfig(weights), MXConfig(acts))
        quantize_llm_(port, QAttentionConfig(tq), tq)
        layouts = {port.model.layers[0].mlp.down_proj.weight.fp4_pack, port.lm_head.weight.fp4_pack}
        assert layouts == ({"quarters", "pair"} if weights == "float6_e3m2" else
                           {"halves"} if weights == "float8_e4m3" and not kw else {"pair"})
        old = jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION
        jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
        try:
            caches = jmodel.init_cache(2, 128, JMXConfig(kv))
            logits, caches = jmodel(jnp.asarray(ids), attention_mask=None,
                                    position_ids=jnp.arange(8)[None, :], caches=caches, cache_position=0)
            ref = [np.asarray(logits[:, -1], np.float32)]
            for i in range(n - 1):
                tok = jnp.asarray(ref[-1].argmax(-1)[:, None], jnp.int32)
                logits, caches = jmodel(tok, attention_mask=None, position_ids=jnp.full((2, 1), 8 + i, jnp.int32),
                                        caches=caches, cache_position=8 + i)
                ref.append(np.asarray(logits[:, -1], np.float32))
        finally:
            jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = old
        got, got_logits = generate(port, torch.from_numpy(ids), n, kv_cache_config=MXConfig(kv),
                                   return_logits=True)
    ref = np.stack(ref, axis=1)
    got, got_logits = got.numpy(), got_logits.numpy()
    for row in range(2):
        for i in range(n):
            r = rel(got_logits[row, i], ref[row, i])
            print(f"{name} row {row} step {i}: logits rel {r:.3e}")
            assert r <= 2e-2
            top2 = np.sort(ref[row, i])[-2:]
            if got[row, i] != ref[row, i].argmax():
                assert top2[1] - top2[0] < TIE_GAP, f"row {row} step {i}: tokens differ at gap {top2[1] - top2[0]}"
                break
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- the CUDA kernels (need a card) --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _within_one_bf16_step(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Every element of a within one bf16 step of b (|b|'s ulp, or the
    smallest normal's near 0)."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126))) - 7)
    return bool(((a - b).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1024, 4096])
@pytest.mark.parametrize("M", [1, 32, 256, 2048])
@pytest.mark.parametrize("act_fq", [None, "float8_e4m3", "int8"])
@pytest.mark.parametrize("elem", kf.CODE_FORMATS_1BYTE)
def test_cuda_1byte_kernel_matches_plain(cuda_device, elem, act_fq, M, K):
    g = torch.Generator().manual_seed(0)
    w = MXTensor.to_mx((torch.randn(256, K, generator=g) * 0.05).to(torch.bfloat16).to(cuda_device), elem).T
    x = torch.randn(M, K, generator=g).to(torch.bfloat16).to(cuda_device)
    out = kf.mx_matmul_1byte(x, w.data, w.scale_e8m0, elem, act_fq)
    ref = kf.mx_matmul_1byte_plain(x, w.data, w.scale_e8m0, elem, act_fq)
    assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("act_fq", [None, "float8_e4m3"])
@pytest.mark.parametrize("K", [1024, 4096])
@pytest.mark.parametrize("M", [1, 32, 65, 256, 2048])
@pytest.mark.parametrize("elem", kf.FP6_FORMATS)
def test_cuda_fp6q_and_fp8_halves_kernels_match_plain(cuda_device, elem, M, K, act_fq):
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(256, K, generator=g) * 0.05).to(torch.bfloat16).to(cuda_device)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16).to(cuda_device)
    q = MXTensor.to_mx(w, elem).T.to_fp6_quarters()
    h = MXTensor.to_mx(w, "float8_e4m3").T.to_fp8_halves()
    for out, ref in ((kf.mx_matmul_fp6q(x, q.data, q.scale_e8m0, elem, act_fq),
                      kf.mx_matmul_fp6q_plain(x, q.data, q.scale_e8m0, elem, act_fq)),
                     (cuda_matmul.mx_matmul_fp8_halves(x, h.data, h.scale_e8m0, act_fq),
                      cuda_matmul.mx_matmul_fp8_halves_plain(x, h.data, h.scale_e8m0, act_fq))):
        assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 17, 256])
@pytest.mark.parametrize("fp8", [False, True])
def test_cuda_int8dot_kernel_matches_plain_and_b6(cuda_device, fp8, M):
    g = torch.Generator().manual_seed(2)
    elem = "float8_e4m3" if fp8 else "int8"
    w = MXTensor.to_mx((torch.randn(256, 1024, generator=g) * 0.05).to(torch.bfloat16).to(cuda_device), elem).T
    x = torch.randn(M, 1024, generator=g).to(torch.bfloat16).to(cuda_device)
    out = kf.mx_matmul_int8dot(x, w.data, w.scale_e8m0, fp8)
    from torchmx_tpu_torch.ops.cuda_quantize import mx_quantize
    sx, xc = mx_quantize(x, elem)
    assert _within_one_bf16_step(out, kf.mx_matmul_int8dot_plain(xc, sx, w.data, w.scale_e8m0, fp8))
    if not fp8:  # exact block sums, the same order and splits: the same bytes as B6
        assert torch.equal(out, kf.mx_matmul_1byte(x, w.data, w.scale_e8m0, "int8", "int8"))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 5, 15, 16, 300])
def test_cuda_rmsnorm_kernel_is_row_invariant(cuda_device, rows):
    from torchmx_tpu_torch.ops.cuda_norm import rms_norm, rms_norm_plain

    g = torch.Generator().manual_seed(3)
    x = torch.randn(512, 4096, generator=g).to(torch.bfloat16).to(cuda_device)
    w = (1 + 0.1 * torch.randn(4096, generator=g)).to(torch.bfloat16).to(cuda_device)
    full = rms_norm(x, w, 1e-5)
    assert torch.equal(rms_norm(x[:rows], w, 1e-5), full[:rows])
    assert _within_one_bf16_step(full, rms_norm_plain(x, w, 1e-5))
