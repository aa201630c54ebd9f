"""The plain PyTorch versions of the port's kernels held against the JAX
Pallas kernels they replace (interpret mode, small shapes), and, on a
machine with a card, the CUDA kernels against their plain versions.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
quantize and fake-quantize bit-exact; matmul rel <= 1e-2 (max abs
difference over max abs output: only the fp32 accumulation order differs);
attention: K4's and K5's plain versions take JAX's KV tiles
(``_pick_lt(L)``) and round p against the same running maxima, so they
equal the JAX kernels bit for bit but for fp32 summation order (K4: at most
0.1 % of the elements differ, each by less than one bf16 step of its
row's largest element; K5:
bit for bit at L = 256 and 2048, elsewhere within a worst-row relative error
of 1e-6); K4 over tiles of 64 positions (the port's fault until its tile was
JAX's) differs in over 1 % of the elements.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.mx_array import MXArray, quantize_mx as jquantize_mx
from torchmx_tpu.ops import pallas_attention as jpa
from torchmx_tpu.ops import pallas_matmul as jpm
from torchmx_tpu.ops import pallas_quantize as jpq
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_attention, cuda_matmul, cuda_quantize

torch.set_num_threads(1)

ELEMS = ["float8_e4m3", "float4_e2m1", "int8", "float6_e3m2", "float6_e2m3"]


def rand_bf16(seed, shape, spread=3.0) -> np.ndarray:
    """Gaussian values with log-normal magnitude spread, as float32 holding
    bf16-representable values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * spread)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def bits(t) -> np.ndarray:
    f = np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()
    out = f.view(np.int32).copy()
    out[np.isnan(f)] = 0x7FC00000
    return out


@pytest.fixture
def pallas_env():
    old = jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
    yield
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = old


@pytest.mark.parametrize("ename", ELEMS)
def test_mx_quantize_plain_matches_pallas_kernel(ename):
    x = rand_bf16(2, (128, 128))
    s_ref, c_ref = jpq.quantize_mx_pallas(jnp.asarray(x, jnp.bfloat16), ename, 32)
    s, c = cuda_quantize.mx_quantize_plain(to_torch(x), ename)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(c.numpy().view(np.uint8), np.asarray(c_ref).view(np.uint8))


@pytest.mark.parametrize("ename", ELEMS)
def test_mx_fake_quantize_plain_matches_pallas_kernel(ename):
    x = rand_bf16(3, (128, 128))
    x[0, 0] = np.nan
    x[1, :32] = 0.0
    ref = jpq.fake_quantize_pallas(jnp.asarray(x, jnp.bfloat16), ename, 32)
    got = cuda_quantize.mx_fake_quantize_plain(to_torch(x), ename)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("M", [8, 96])
@pytest.mark.parametrize("act_fq", [None, "float8_e4m3"])
def test_mx_matmul_fp4_halves_plain_matches_pallas_kernel(M, act_fq):
    K, N = 512, 256
    x = rand_bf16(4, (M, K), spread=1.0)
    w = (np.random.default_rng(5).standard_normal((N, K)) * 0.05).astype(np.float32)
    jw = MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), "float4_e2m1", 32).T.to_fp4_halves()
    ref = jpm.matmul_any(jnp.asarray(x, jnp.bfloat16), jw, jnp.bfloat16, act_fq=act_fq)
    tw = MXTensor.to_mx(to_torch(w), "float4_e2m1", 32).T.to_fp4_halves()
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    got = cuda_matmul.mx_matmul_fp4_halves_plain(to_torch(x), tw.data, tw.scale_e8m0, act_fq)
    r = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - r).max() / np.abs(r).max()
    assert err <= 1e-2, err


def test_fp4_decode_matches_jax_on_every_nibble_and_scale():
    """K3's plain fp4 decode (``decode_fp4_to_bf16``, which the kernel's
    decode equals bit for bit on the card) gives the bits of the JAX
    package's ``decode_fp4_to_bf16`` for all 16 x 256 (nibble, scale)
    pairs, flushed and wrapped results included."""
    nib, se = np.meshgrid(np.arange(16, dtype=np.int32), np.arange(256, dtype=np.int32), indexing="ij")
    ref = jpm.decode_fp4_to_bf16(jnp.asarray(nib), jnp.asarray(se))
    got = cuda_matmul.decode_fp4_to_bf16(torch.from_numpy(nib), torch.from_numpy(se))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))


def test_unfused_activation_formats_take_two_passes():
    """K3 fuses only fp8 activations and rejects other formats; with an fp6
    activation ``mx_dynamic_matmul`` fake-quantizes first and then runs K3
    without ``act_fq``, matching the Pallas kernel's fused fp6 (rel <= 1e-2)."""
    from torchmx_tpu_torch.ops.matmul import mx_dynamic_matmul

    M, K, N = 8, 512, 256
    x = rand_bf16(9, (M, K), spread=1.0)
    w = (np.random.default_rng(10).standard_normal((N, K)) * 0.05).astype(np.float32)
    jw = MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), "float4_e2m1", 32).T.to_fp4_halves()
    ref = np.asarray(jpm.matmul_any(jnp.asarray(x, jnp.bfloat16), jw, jnp.bfloat16,
                                    act_fq="float6_e3m2"), np.float32)
    tw = MXTensor.to_mx(to_torch(w), "float4_e2m1", 32).T.to_fp4_halves()
    with pytest.raises(ValueError, match="act_fq"):
        cuda_matmul.mx_matmul_fp4_halves(to_torch(x), tw.data, tw.scale_e8m0, "float6_e3m2")
    got = mx_dynamic_matmul(to_torch(x), tw, "float6_e3m2")
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-2, err


def _mx_cache(seed, b, hkv, L, d, elem="float8_e4m3"):
    rng = np.random.default_rng(seed)
    k = np.asarray(jnp.asarray(rng.standard_normal((b, hkv, L, d)), jnp.bfloat16))
    v = np.asarray(jnp.asarray(rng.standard_normal((b, hkv, L, d)), jnp.bfloat16))
    ks, kd = jquantize_mx(jnp.asarray(k), elem, 32)
    vs, vd = jquantize_mx(jnp.asarray(v), elem, 32)
    return types.SimpleNamespace(
        k_data=kd, k_scale=ks, v_data=vd, v_scale=vs, elem_dtype_name=elem,
        block_size=32, layout="seq",
    )


def _cache_tensors(cache):
    return [torch.from_numpy(np.array(getattr(cache, k))) for k in ("k_data", "k_scale", "v_data", "v_scale")]


def assert_jax_bits(got: torch.Tensor, ref) -> None:
    """K4's and K6's plain versions against JAX's kernel at JAX's tile: bit
    for bit but for fp32 summation order in rare elements (at most 0.1 % of
    them differ, each by less than one bf16 step of its row's largest
    element)."""
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    assert (g != r).mean() <= 1e-3, (g != r).mean()
    assert (np.abs(g - r) <= 2.0 ** -7 * np.abs(r).max(axis=-1, keepdims=True)).all()


# (L, sq, kv_len of each row): the query positions end at kv_len; prefixes at
# and past JAX's tile edges (lt = 256 at L = 256, 512 at 1024, 128 at 1152,
# where the kernel's shares hold two tiles each).
K4_JAX_CASES = [(256, 1, [256, 129, 57]), (256, 16, [256, 129, 57]), (1024, 1, [512, 513, 1024]),
                (1152, 1, [128, 129, 257, 1152])]


def _k4_against_jax(elem, L, sq, kv, tile=None, seed=6):
    """(plain K4 at ``tile``, JAX's cached_attention_any) on one ragged batch."""
    b, hq, hkv, d = len(kv), 4, 2, 128
    cache = _mx_cache(seed, b, hkv, L, d, elem)
    q = rand_bf16(seed + 1, (b, hq, sq, d), spread=0.5)
    kv_len = np.array(kv, np.int32)
    q_off = kv_len - sq
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), cache, jnp.asarray(q_off),
                                   jnp.asarray(kv_len), d ** -0.5)
    assert ref is not None
    got = cuda_attention.mx_cached_attention_plain(
        to_torch(q), *_cache_tensors(cache), torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5, elem,
        tile=tile,
    )
    return got, ref


@pytest.mark.parametrize("elem", ["float8_e4m3", "float6_e3m2", "float6_e2m3"])
@pytest.mark.parametrize("L, sq, kv", K4_JAX_CASES, ids=["L=256 sq=1", "L=256 sq=16", "L=1024 sq=1", "L=1152 sq=1"])
def test_mx_cached_attention_plain_matches_pallas_kernel(pallas_env, elem, L, sq, kv):
    """K4's plain version at JAX's tile against the JAX kernel, ragged rows."""
    assert_jax_bits(*_k4_against_jax(elem, L, sq, kv))


def test_mx_cached_attention_plain_at_64_positions_differs_from_pallas(pallas_env):
    """The fault the plain version had until it took JAX's tile: p rounded
    against the running maximum through tiles of 64 positions differs from
    JAX in over 1 % of the elements (12-18 % on these inputs)."""
    got, ref = _k4_against_jax("float8_e4m3", 256, 16, [256, 200, 57], tile=64)
    assert (got.float().numpy() != np.asarray(ref, np.float32)).mean() > 1e-2


@pytest.mark.parametrize("L", [128, 256, 384, 1024, 1152, 2048, 4096, 8192])
def test_online_attention_default_tile_is_jax_tile(L):
    """The plain versions' default tile is JAX's ``_pick_lt(L)``: the same
    bytes as with that tile named, at any L JAX's plan serves."""
    lt = jpa._pick_lt(L)
    assert cuda_attention.attention_tile(L) == lt
    rng = np.random.default_rng(L)
    k, v = (torch.from_numpy(rand_bf16(int(rng.integers(1 << 30)), (1, 1, L, 32), spread=0.3)).to(torch.bfloat16)
            for _ in "kv")
    q = torch.from_numpy(rand_bf16(3, (1, 2, 32, 32), spread=1.0)).to(torch.bfloat16)
    args = (q, k, v, L - 32, L, 32 ** -0.5, torch.float32)
    assert torch.equal(cuda_attention._online_attention(*args), cuda_attention._online_attention(*args, tile=lt))
    assert not torch.equal(cuda_attention._online_attention(*args), cuda_attention._online_attention(*args, tile=64))


def test_no_jax_tile_takes_the_whole_cache():
    """Where no JAX tile divides L (L % 128 != 0: JAX's plan serves no kernel;
    generate and the engine round their caches to 128 positions), K4 and K6
    take the whole cache as their tile, the kernel in shares that divide it;
    a cache not a multiple of 64 positions is refused on the card."""
    L = 192
    assert jpa.plan_cached_attention(4, 2, 1, L, 128, "float8_e4m3") is None
    assert cuda_attention.attention_tile(L) == L and cuda_attention.attention_plan(L, 4) == (L, 64, False)
    kd, ks, vd, vs = _cache_tensors(_mx_cache(8, 2, 2, L, 128))
    q = to_torch(rand_bf16(9, (2, 4, 3, 128), spread=0.5))
    args = (q, kd, ks, vd, vs, torch.tensor([100, 189]), torch.tensor([103, 192]), 128 ** -0.5, "float8_e4m3")
    whole = cuda_attention.mx_cached_attention_plain(*args)
    assert torch.equal(whole, cuda_attention.mx_cached_attention_plain(*args, tile=L))
    assert not torch.equal(whole, cuda_attention.mx_cached_attention_plain(*args, tile=64))
    with pytest.raises(ValueError, match="L % 64"):
        cuda_attention.attention_plan(160, 4)


@pytest.mark.parametrize("hq,hkv", [(32, 8), (4, 2)])
def test_chunkdot_attention_plain_matches_pallas_kernel(pallas_env, hq, hkv):
    """K5's plain version against the JAX chunk-dot kernel (int8 cache, one
    query position): rows at their own positions, one of them seeing less
    than the written prefix (``kv_len`` below ``q_off + 1``)."""
    b, d, L = 3, 128, 256
    cache = _mx_cache(11, b, hkv, L, d, "int8")
    q = rand_bf16(12, (b, hq, 1, d), spread=0.5)
    q_off = np.array([0, 130, 255], np.int32)
    kv_len = np.array([1, 100, 256], np.int32)
    assert jpa.use_chunkdot("int8", 1, d)
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), cache, jnp.asarray(q_off),
                                   jnp.asarray(kv_len), d ** -0.5)
    got = cuda_attention.mx_cached_attention_chunkdot_plain(
        to_torch(q), *_cache_tensors(cache), torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5)
    assert got.shape == (b, hq, 1, d) and got.dtype == torch.bfloat16
    assert np.array_equal(bits(got), bits(ref))  # JAX's tile of 256: its arithmetic, bit for bit
    # The dispatch reaches it, and the general kernel's plain version agrees.
    port_cache = types.SimpleNamespace(**dict(zip(("k_data", "k_scale", "v_data", "v_scale"), _cache_tensors(cache))),
                                       elem_dtype_name="int8", block_size=32)
    via = cuda_attention.cached_attention_any(to_torch(q), port_cache, torch.from_numpy(q_off),
                                              torch.from_numpy(kv_len), d ** -0.5)
    assert torch.equal(via, got)
    k4 = cuda_attention.mx_cached_attention_plain(
        to_torch(q), *_cache_tensors(cache), torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5, "int8")
    assert (k4.float() - got.float()).abs().max().item() <= 2e-2


def _worst_row_rel(got: torch.Tensor, ref) -> float:
    a, r = got.double().numpy(), np.asarray(ref, np.float64)
    num = np.linalg.norm(a - r, axis=-1)
    return float(np.max(np.where(num == 0, 0.0, num / np.maximum(np.linalg.norm(r, axis=-1), 1e-300))))


# (L, JAX's tile, q_off, kv_len): rows at and around the tile edges, one
# seeing less than its written prefix.
CHUNKDOT_EDGES = {1024: (512, [511, 512, 1023], [512, 513, 700]),
                  1152: (128, [127, 1024, 1151], [128, 1025, 1152]),
                  2048: (1024, [1023, 1024, 2047], [1024, 1025, 2048])}


@pytest.mark.parametrize("L", sorted(CHUNKDOT_EDGES))
def test_chunkdot_attention_plain_matches_pallas_kernel_at_tile_edges(pallas_env, L):
    """K5's plain version against the JAX chunk-dot kernel over two and more
    of JAX's tiles (512 at L = 1024, 128 at 1152: nine tiles, more than K5's
    cluster has CTAs, 1024 at 2048), rows whose visible prefix ends at, just
    past and before a tile edge: bit for bit at L = 2048, and elsewhere
    within a worst-row relative error of 1e-6 (fp32 summation order: at L =
    1024 0.1 % of elements differ, by at most a few 1e-9)."""
    b, hq, hkv, d = 3, 4, 2, 128
    lt, q_off, kv_len = CHUNKDOT_EDGES[L]
    assert jpa._pick_lt(L) == lt == cuda_attention.attention_tile(L)
    cache = _mx_cache(11, b, hkv, L, d, "int8")
    q = rand_bf16(12, (b, hq, 1, d), spread=0.5)
    q_off, kv_len = np.array(q_off, np.int32), np.array(kv_len, np.int32)
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), cache, jnp.asarray(q_off),
                                   jnp.asarray(kv_len), d ** -0.5)
    got = cuda_attention.mx_cached_attention_chunkdot_plain(
        to_torch(q), *_cache_tensors(cache), torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5)
    if L == 2048:
        assert np.array_equal(bits(got), bits(ref))
    assert _worst_row_rel(got, ref) <= 1e-6
    # Tiles of 32 round p against other running maxima: not JAX's function.
    old = cuda_attention.mx_cached_attention_chunkdot_plain(
        to_torch(q), *_cache_tensors(cache), torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5, tile=32)
    assert not np.array_equal(bits(old), bits(ref)) and _worst_row_rel(old, ref) > 1e-4


@pytest.mark.parametrize("L", [64, 192, 1000, 256, 1024, 1152, 1408, 2304, 8192, 8320, 16384, 16512, 32640,
                               32768, 32896])
def test_chunkdot_dispatch_needs_a_jax_tile(L):
    """K5 serves a cache length wherever JAX's plan has a tile for it (else
    JAX serves no kernel and K4 serves the call), up to 32768, the longest
    context of the port's models: a CTA takes a part of a tile, or, where
    the cache holds more than the cluster's 8 CTAs of tiles (L = 1152: 9 of
    128), whole consecutive tiles, at most ``K5_MAX_SHARE`` positions."""
    want = jpa.plan_cached_attention(32, 8, 1, L, 128, "int8") is not None and L <= 32768
    assert cuda_attention.use_chunkdot("int8", 1, 128, 4, L) == want
    assert (L % 128 != 0) == (jpa._pick_lt(L) is None) and cuda_attention.attention_tile(L) == (jpa._pick_lt(L) or L)
    if want:
        lt, P = cuda_attention.attention_tile(L), cuda_attention.k5_share(L)
        assert (lt % P == 0 or P % lt == 0) and -(-L // P) <= cuda_attention.K5_MAX_SHARES
        assert P <= cuda_attention.K5_MAX_SHARE


def test_chunkdot_attention_plain_edge_rows():
    """A row with no visible key outputs 0; never-written slots (code 0,
    scale 0) and a stale NaN-scale slot past the prefix change nothing."""
    b, hq, hkv, d, L = 2, 4, 2, 128, 64
    kd, ks, vd, vs = _cache_tensors(_mx_cache(13, b, hkv, L, d, "int8"))
    q = to_torch(rand_bf16(14, (b, hq, 1, d), spread=0.5))
    q_off, kv_len = torch.tensor([0, 40]), torch.tensor([0, 41])
    ref = cuda_attention.mx_cached_attention_chunkdot_plain(q, kd, ks, vd, vs, q_off, kv_len, d ** -0.5)
    assert ref[0].abs().max() == 0 and ref[1].abs().max() > 0
    for t in (kd, ks, vd, vs):
        t[:, :, 41:] = 0
    ks[:, :, 50], vs[:, :, 50] = 255, 255
    got = cuda_attention.mx_cached_attention_chunkdot_plain(q, kd, ks, vd, vs, q_off, kv_len, d ** -0.5)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("L, sq, kv", [(256, 8, [8, 136, 256]), (256, 16, [256, 129, 57]), (256, 64, [64, 192, 256]),
                                       (1024, 8, [512, 513, 1024]), (1152, 8, [129, 640, 1152])],
                         ids=["L=256 sq=8", "L=256 sq=16", "L=256 sq=64", "L=1024 sq=8", "L=1152 sq=8"])
def test_mx_cached_attention_plain_int8_matches_pallas_kernel(pallas_env, L, sq, kv):
    """K4's plain version over an int8 cache (prefill and chunks: at one
    query position the dispatch sends an int8 cache to K5) against the JAX
    kernel's int8 branch, at JAX's tile."""
    assert_jax_bits(*_k4_against_jax("int8", L, sq, kv, seed=15))


@pytest.mark.parametrize("elem", ["int8", "float8_e4m3", "float6_e3m2"])
@pytest.mark.parametrize("sq", [1, 2, 64])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_chunkdot_dispatch_rule_matches_jax(elem, sq, d):
    """The port's rule is JAX's, cut to the shapes K5 takes: head_dim 128 and
    1 to 8 query heads per KV head (d = 256 and groups above 8 are JAX tiers
    not ported: there the predicate says no, and K4 serves)."""
    for group in (1, 2, 3, 4, 5, 6, 7, 8, 16):
        want = jpa.use_chunkdot(elem, sq, d) and d == 128 and group <= 8
        assert cuda_attention.use_chunkdot(elem, sq, d, group, 256) == want


def test_attention_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16)
    kd = torch.zeros(1, 2, 64, 128, dtype=torch.int8)
    ks = torch.zeros(1, 2, 64, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="sq == 1"):
        cuda_attention.mx_cached_attention_chunkdot(q, kd, ks, kd, ks, 0, 2, 1.0)
    with pytest.raises(ValueError, match="int8 cache"):
        cuda_attention.mx_cached_attention_chunkdot(q[:, :, :1], kd.view(torch.uint8), ks, kd.view(torch.uint8), ks, 0, 1, 1.0)


def test_wrappers_take_the_plain_path_on_cpu():
    """On a CPU tensor a wrapper returns its plain version's result and
    launches nothing."""
    from torchmx_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launch_counts()
    x = to_torch(rand_bf16(8, (4, 64)))
    s, c = cuda_quantize.mx_quantize(x, "float8_e4m3")
    sp, cp = cuda_quantize.mx_quantize_plain(x, "float8_e4m3")
    assert torch.equal(s, sp) and torch.equal(c, cp)
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- the CUDA kernels (need a card) --------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 32, 256])
def test_cuda_matmul_kernel_matches_plain(cuda_device, M):
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(1024, 512, generator=g) * 0.05).to(torch.bfloat16)
    tw = MXTensor.to_mx(w.to(cuda_device), "float4_e2m1", 32).T.to_fp4_halves()
    x = torch.randn(M, 512, generator=g).to(torch.bfloat16).to(cuda_device)
    out = cuda_matmul.mx_matmul_fp4_halves(x, tw.data, tw.scale_e8m0, "float8_e4m3")
    ref = cuda_matmul.mx_matmul_fp4_halves_plain(x, tw.data, tw.scale_e8m0, "float8_e4m3")
    assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("act_fq", [None, "float8_e4m3"])
@pytest.mark.parametrize("M", [1, 32, 65, 2048])
@pytest.mark.parametrize("K", [512, 4096])
@pytest.mark.parametrize("elem", ["float4_e2m1", "float8_e4m3"])
def test_cuda_halves_kernels_match_plain(cuda_device, elem, K, M, act_fq):
    """K3 over fp4 and fp8 halves against its plain version, rel <= 1e-2,
    at N = 576 (a ragged last column tile) and 4096."""
    g = torch.Generator().manual_seed(2)
    for N in (576, 4096):
        w = MXTensor.to_mx((torch.randn(N, K, generator=g) * 0.05).to(torch.bfloat16).to(cuda_device), elem).T
        w = w.to_fp4_halves() if elem == "float4_e2m1" else w.to_fp8_halves()
        x = torch.randn(M, K, generator=g).to(torch.bfloat16).to(cuda_device)
        fn, plain = ((cuda_matmul.mx_matmul_fp4_halves, cuda_matmul.mx_matmul_fp4_halves_plain)
                     if elem == "float4_e2m1" else
                     (cuda_matmul.mx_matmul_fp8_halves, cuda_matmul.mx_matmul_fp8_halves_plain))
        out, ref = fn(x, w.data, w.scale_e8m0, act_fq), plain(x, w.data, w.scale_e8m0, act_fq)
        assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2
