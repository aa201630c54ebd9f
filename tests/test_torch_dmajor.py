"""The d-major MX KV cache of the port and its two attention kernels' plain
versions, held against the JAX package on the CPU (Pallas kernels in
interpret mode, small shapes; inputs from a numpy seed, fed to both sides).

Tolerances: cache buffers bit-equal; plain K6 (``mx_cached_attention_dmajor``),
which takes JAX's tile (``_pick_lt(L)``) and rounds p against the same
running maxima, equal to the JAX d-major kernel bit for bit but for fp32
summation order (at most 0.1 % of the elements differ, each by less than one
bf16 step of its row's largest element); plain K7
(``mx_cached_attention_int8dot``), which takes JAX's
tile (``_pick_lt(L)``) by default, equal to the JAX kernel bit for bit (the
same arithmetic in the same order), through the dispatch too, its q codes and
scales bit-equal, and an SQNR above 30 dB against exact attention, the JAX
package's own bound for this path.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.models.llama import MXLayerKVCache as JCache
from torchmx_tpu.mx_array import quantize_mx as jquantize_mx
from torchmx_tpu.ops import pallas_attention as jpa
from torchmx_tpu_torch import env_variables as env
from torchmx_tpu_torch.convert import cache_from_buffers
from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_mla

torch.set_num_threads(1)

FORMATS = ["float8_e4m3", "int8", "float4_e2m1"]
NAMES = ("k_data", "k_scale", "v_data", "v_scale")


def bf16(x) -> np.ndarray:
    """float32 array holding bf16-representable values."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture
def flags():
    """Sets ``TORCHMX_ATTN_INT8_DOT`` on both packages' env modules, with the
    JAX package on its Pallas path; restores all of it afterwards."""
    old = jenv.TORCHMX_FUSED_ATTENTION, jenv.TORCHMX_ATTN_INT8_DOT, env.TORCHMX_ATTN_INT8_DOT
    jenv.TORCHMX_FUSED_ATTENTION = "pallas"

    def set_flag(value: str):
        jenv.TORCHMX_ATTN_INT8_DOT = env.TORCHMX_ATTN_INT8_DOT = value

    yield set_flag
    jenv.TORCHMX_FUSED_ATTENTION, jenv.TORCHMX_ATTN_INT8_DOT, env.TORCHMX_ATTN_INT8_DOT = old


def filled_caches(seed, b, hkv, L, d, elem):
    """(JAX cache, port cache) in the d-major layout, every position written
    from the same random K/V."""
    rng = np.random.default_rng(seed)
    k, v = bf16(rng.standard_normal((b, hkv, L, d))), bf16(rng.standard_normal((b, hkv, L, d)))
    jc = JCache.create(b, hkv, L, d, elem, 32, layout="dmajor").write(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), 0)
    tc = cache_from_buffers(*(np.asarray(getattr(jc, n)) for n in NAMES), elem, "dmajor", device="cpu")
    return jc, tc


# -- (a) the cache ------------------------------------------------------------------


@pytest.mark.parametrize("elem", FORMATS)
def test_dmajor_cache_write_matches_jax_bit_for_bit(elem):
    """Codes and scales after a series of writes: an int position, (b,)
    positions, and starts that run past the buffer and are clamped (row 2
    writes 3 positions at 30 into a cache of 32, row 3 one at ``max_len``)."""
    b, h, L, d = 4, 2, 32, 64
    rng = np.random.default_rng(7)
    jc = JCache.create(b, h, L, d, elem, 32, layout="dmajor")
    tc = MXLayerKVCache.create(b, h, L, d, elem, device="cpu", layout="dmajor")
    assert tc.layout == "dmajor" and tc.max_len == jc.max_len == L
    assert tuple(tc.k_data.shape) == tuple(jc.k_data.shape) and tuple(tc.k_scale.shape) == tuple(jc.k_scale.shape)
    writes = ((6, 2), (5, [0, 3, 27, 11]), (3, [5, 0, 30, 29]), (1, [8, 31, 4, 32]), (1, 31), (1, [9, 2, 40, 0]))
    for s_len, pos in writes:
        k = bf16(rng.standard_normal((b, h, s_len, d)))
        v = bf16(rng.standard_normal((b, h, s_len, d)) * 8)
        per_row = not isinstance(pos, int)
        jc = jc.write(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                      jnp.asarray(pos, jnp.int32) if per_row else pos)
        tc.write(to_torch(k), to_torch(v), torch.tensor(pos, dtype=torch.int32) if per_row else pos)
        for name in NAMES:
            np.testing.assert_array_equal(getattr(tc, name).numpy().view(np.uint8),
                                          np.asarray(getattr(jc, name)).view(np.uint8), err_msg=f"{name} {pos}")
    for got, ref in zip(tc.dequantize(), jc.dequantize()):
        assert tuple(got.shape) == (b, h, L, d)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    with pytest.raises(ValueError, match="cannot take positions"):
        tc.write(torch.zeros(b, h, 2, d), torch.zeros(b, h, 2, d), 31)


@pytest.mark.parametrize("elem", ["float8_e4m3", "int8"])
def test_both_layouts_hold_the_same_values(elem):
    """The same writes into a seq and a d-major cache dequantize alike, the
    buffers differ by a swap of the last two axes, ``clone`` keeps the
    layout, and ``cache_from_buffers`` converts between them."""
    b, h, L, d = 2, 2, 16, 64
    rng = np.random.default_rng(8)
    seq = MXLayerKVCache.create(b, h, L, d, elem, device="cpu", layout="seq")
    dm = MXLayerKVCache.create(b, h, L, d, elem, device="cpu", layout="dmajor")
    for pos in (0, torch.tensor([5, 9], dtype=torch.int32)):
        k, v = to_torch(bf16(rng.standard_normal((b, h, 4, d)))), to_torch(bf16(rng.standard_normal((b, h, 4, d))))
        seq.write(k, v, pos)
        dm.write(k, v, pos)
    for a, c in zip(seq.dequantize(), dm.dequantize()):
        assert torch.equal(a, c)
    for a, c in zip(seq.buffers, dm.clone().buffers):
        assert torch.equal(a, c.transpose(2, 3))
    assert dm.clone().layout == "dmajor"
    back = cache_from_buffers(*(t.numpy() for t in dm.buffers), elem, "dmajor", to_layout="seq", device="cpu")
    assert back.layout == "seq" and all(torch.equal(a, c) for a, c in zip(seq.buffers, back.buffers))


def test_layout_defaults_to_the_env_flag_and_fp4_needs_dmajor(monkeypatch):
    assert env.TORCHMX_KV_LAYOUT == "seq" and env.TORCHMX_ATTN_INT8_DOT == "0"  # the defaults
    assert MXLayerKVCache.create(1, 1, 8, 64, "int8", device="cpu").layout == "seq"
    monkeypatch.setattr(env, "TORCHMX_KV_LAYOUT", "dmajor")
    c = MXLayerKVCache.create(1, 2, 8, 64, "float4_e2m1", device="cpu")
    assert c.layout == "dmajor" and tuple(c.k_data.shape) == (1, 2, 32, 8) and tuple(c.k_scale.shape) == (1, 2, 2, 8)
    with pytest.raises(NotImplementedError, match="d-major layout only"):
        MXLayerKVCache.create(1, 1, 8, 64, "float4_e2m1", device="cpu", layout="seq")
    with pytest.raises(ValueError, match="unknown KV cache layout"):
        MXLayerKVCache.create(1, 1, 8, 64, "int8", device="cpu", layout="rows")


# -- (b) plain K6 against the JAX d-major kernel ---------------------------------------


def assert_jax_bits(got: torch.Tensor, ref) -> None:
    """Plain K6 against JAX's kernel at JAX's tile: bit for bit but for fp32
    summation order in rare elements (at most 0.1 % of them differ, each by
    less than one bf16 step of its row's largest element)."""
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    assert (g != r).mean() <= 1e-3, (g != r).mean()
    assert (np.abs(g - r) <= 2.0 ** -7 * np.abs(r).max(axis=-1, keepdims=True)).all()


# (L, sq, kv_len of each row): the query positions end at kv_len; prefixes at
# and past JAX's tile edges (lt = 256 at L = 256, 512 at 1024, 128 at 1152,
# where the kernel's shares hold two tiles each).
K6_JAX_CASES = [(256, 1, [256, 129, 57]), (256, 4, [4, 200, 256]), (256, 16, [256, 129, 57]),
                (256, 64, [64, 200, 256]), (1024, 1, [512, 513, 1024]), (1152, 1, [128, 129, 257, 1152])]


@pytest.mark.parametrize("elem", FORMATS)
@pytest.mark.parametrize("L, sq, kv", K6_JAX_CASES,
                         ids=["L=256 sq=1", "L=256 sq=4", "L=256 sq=16", "L=256 sq=64", "L=1024 sq=1",
                              "L=1152 sq=1"])
def test_dmajor_attention_plain_matches_pallas_kernel(flags, elem, L, sq, kv):
    flags("0")
    b, hq, hkv, d = len(kv), 4, 2, 128
    jc, tc = filled_caches(21, b, hkv, L, d, elem)
    q = bf16(np.random.default_rng(22).standard_normal((b, hq, sq, d)) * 0.5)
    kv_len = np.array(kv, np.int32)
    q_off = kv_len - sq  # ragged rows
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), jc, jnp.asarray(q_off), jnp.asarray(kv_len), d ** -0.5)
    got = ca.mx_cached_attention_dmajor_plain(to_torch(q), *tc.buffers, torch.from_numpy(q_off),
                                              torch.from_numpy(kv_len), d ** -0.5, elem)
    assert got.shape == (b, hq, sq, d) and got.dtype == torch.bfloat16
    assert_jax_bits(got, ref)
    # The dispatch and the wrapper reach it on CPU tensors.
    via = ca.cached_attention_any(to_torch(q), tc, torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5)
    assert torch.equal(via, got)


def test_dmajor_attention_plain_at_64_positions_differs_from_pallas(flags):
    """The fault plain K6 had until it took JAX's tile: p rounded against the
    running maximum through tiles of 64 positions differs from JAX in over 1 %
    of the elements."""
    flags("0")
    b, hq, hkv, d, L, sq = 3, 4, 2, 128, 1024, 1
    jc, tc = filled_caches(25, b, hkv, L, d, "float4_e2m1")
    q = bf16(np.random.default_rng(26).standard_normal((b, hq, sq, d)) * 0.5)
    kv_len = np.array([512, 513, 1024], np.int32)
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), jc, jnp.asarray(kv_len - 1), jnp.asarray(kv_len),
                                   d ** -0.5)
    got = ca.mx_cached_attention_dmajor_plain(to_torch(q), *tc.buffers, torch.from_numpy(kv_len - 1),
                                              torch.from_numpy(kv_len), d ** -0.5, "float4_e2m1", tile=64)
    assert (got.float().numpy() != np.asarray(ref, np.float32)).mean() > 1e-2


@pytest.mark.parametrize("elem", ["float8_e4m3", "int8"])
def test_dmajor_attention_plain_equals_the_seq_version(elem):
    """On the same cache content plain K6 and plain K4 are one computation."""
    b, hq, hkv, d, L, sq = 2, 4, 2, 128, 128, 8
    _, tc = filled_caches(23, b, hkv, L, d, elem)
    q = to_torch(bf16(np.random.default_rng(24).standard_normal((b, hq, sq, d)) * 0.5))
    q_off = torch.tensor([0, 100], dtype=torch.int32)
    got = ca.mx_cached_attention_dmajor_plain(q, *tc.buffers, q_off, q_off + sq, d ** -0.5, elem)
    seq = [t.transpose(2, 3).contiguous() for t in tc.buffers]
    assert torch.equal(got, ca.mx_cached_attention_plain(q, *seq, q_off, q_off + sq, d ** -0.5, elem))


# -- (c) plain K7 against the JAX all-int8 kernel --------------------------------------


def _int8dot_against_jax(flags, seed, b, hq, hkv, L, q_off, kv_len):
    """Plain K7 at its default tile and the dispatch against JAX's
    ``cached_attention_any`` on the int8-dot path, bit for bit; returns the
    port's output, its inputs and the cache."""
    flags("1")
    d = 128
    jc, tc = filled_caches(seed, b, hkv, L, d, "int8")
    q = bf16(np.random.default_rng(seed + 1).standard_normal((b, hq, 1, d)) * 0.5)
    q_off, kv_len = np.array(q_off, np.int32), np.array(kv_len, np.int32)
    assert jpa.use_int8dot(jc, 1, d) and ca.use_int8dot(tc, 1, d)
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), jc, jnp.asarray(q_off), jnp.asarray(kv_len), d ** -0.5)
    args = (to_torch(q), *tc.buffers, torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5)
    got = ca.mx_cached_attention_int8dot_plain(*args)
    assert got.shape == (b, hq, 1, d) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    via = ca.cached_attention_any(to_torch(q), tc, torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5)
    assert torch.equal(via, got)
    return got, q, q_off, kv_len, tc


def test_int8dot_attention_plain_matches_pallas_kernel(flags):
    """At JAX's own tile (512 at L = 1024: two tiles, so the per-tile
    requantization of p is exercised) and at per-row positions, one row
    seeing less than the written prefix: bit for bit, through the dispatch
    too; q's codes and scales are the JAX wrapper's; accurate enough."""
    b, hq, hkv, d, L = 3, 8, 2, 128, 1024
    via, q, q_off, kv_len, tc = _int8dot_against_jax(flags, 31, b, hq, hkv, L, [0, 900, 1023], [1, 700, 1024])
    js, jd = jquantize_mx(jnp.asarray(q, jnp.bfloat16).reshape(b, hkv, hq // hkv, d), "int8", 32)
    ts, td = ca.quantize_q_int8(to_torch(q), hkv)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    k, v = (t.double().repeat_interleave(hq // hkv, 1) for t in tc.dequantize())
    s = (torch.from_numpy(q).double() @ k.transpose(-1, -2)) * d ** -0.5
    visible = torch.arange(L)[None] < torch.from_numpy(np.minimum(kv_len, q_off + 1))[:, None]
    exact = torch.softmax(s.masked_fill(~visible[:, None, None], float("-inf")), -1) @ v
    sqnr = 10 * torch.log10(exact.square().sum() / (via.double() - exact).square().sum())
    assert sqnr > 30, float(sqnr)


def test_int8dot_attention_plain_matches_pallas_kernel_at_one_tile(flags):
    """L = 256 (one JAX tile of 256 positions), 2 x 8 heads over 2 KV heads."""
    _int8dot_against_jax(flags, 33, 2, 8, 2, 256, [100, 255], [101, 200])


@pytest.mark.parametrize("L", [128, 256, 384, 512, 1024, 2048, 4096, 8192, 16384])
def test_pick_lt_is_jax_s(L):
    """The port's one copy of JAX's KV tile (K7's requantization unit, B14's
    and the MLA plan's tile) is JAX's function."""
    assert ca._pick_lt(L) == jpa._pick_lt(L)
    assert cuda_mla._pick_lt is ca._pick_lt


# -- (d) the dispatch rule ---------------------------------------------------------------


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("layout", ["seq", "dmajor"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq", [1, 2, 64])
@pytest.mark.parametrize("elem", ["int8", "float8_e4m3", "float4_e2m1"])
def test_int8dot_rule_matches_jax(flags, elem, sq, d, layout, flag):
    """JAX's rule, cut to the shapes K7 takes (head_dim 128, 1 to 8 query
    heads per KV head; groups above 8 are a JAX tier not ported)."""
    flags(flag)
    cache = types.SimpleNamespace(elem_dtype_name=elem, layout=layout)
    for group in (1, 2, 3, 4, 5, 6, 7, 8, 16):
        want = jpa.use_int8dot(cache, sq, d) and d == 128 and group <= 8
        assert ca.use_int8dot(cache, sq, d, group) == want


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("layout", ["seq", "dmajor"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("elem", ["int8", "float8_e4m3"])
def test_dispatch_picks_the_kernel_jax_picks(flags, monkeypatch, elem, sq, layout, flag):
    """Which of the four attention paths ``cached_attention_any`` takes, in
    both packages, over a grid of format, query length, layout and flag."""
    flags(flag)
    b, hq, hkv, d, L = 1, 4, 2, 128, 128
    calls = []
    for name, kernel in (("_int8dot_attention", "int8dot"), ("_mx_cached_attention_dmajor", "dmajor"),
                         ("_chunkdot_attention", "chunkdot"), ("_mx_cached_attention", "seq")):
        def fake(q, *a, _kernel=kernel, **kw):
            calls.append(("jax", _kernel))
            return jnp.zeros(q.shape, jnp.bfloat16)  # (b, hq, 1, d), or q4 (b, hkv, sq * g, d)
        monkeypatch.setattr(jpa, name, fake)
    for name, kernel in (("mx_cached_attention_int8dot", "int8dot"), ("mx_cached_attention_dmajor", "dmajor"),
                         ("mx_cached_attention_chunkdot", "chunkdot"), ("mx_cached_attention", "seq")):
        monkeypatch.setattr(ca, name, lambda q, *a, _kernel=kernel, **kw: calls.append(("port", _kernel)))
    jc = JCache.create(b, hkv, L, d, elem, 32, layout=layout)
    tc = MXLayerKVCache.create(b, hkv, L, d, elem, device="cpu", layout=layout)
    jpa.cached_attention_any(jnp.zeros((b, hq, sq, d), jnp.bfloat16), jc, 0, sq, 1.0)
    ca.cached_attention_any(torch.zeros(b, hq, sq, d, dtype=torch.bfloat16), tc, 0, sq, 1.0)
    assert len(calls) == 2 and calls[0][1] == calls[1][1], calls
    want = {"seq": "chunkdot" if elem == "int8" and sq == 1 else "seq",
            "dmajor": "int8dot" if elem == "int8" and sq == 1 and flag == "1" else "dmajor"}[layout]
    assert calls[1] == ("port", want)


# -- (e) edge rows -------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["dmajor", "int8dot"])
def test_dmajor_plain_edge_rows(kernel):
    """A row with no visible key outputs 0; never-written slots (code 0,
    scale 0) and a stale slot with scale 255 past the prefix change nothing."""
    b, hq, hkv, d, L = 2, 4, 2, 128, 256
    _, tc = filled_caches(41, b, hkv, L, d, "int8")
    q = to_torch(bf16(np.random.default_rng(42).standard_normal((b, hq, 1, d)) * 0.5))
    q_off, kv_len = torch.tensor([0, 140]), torch.tensor([0, 141])

    def run(buffers):
        if kernel == "int8dot":
            return ca.mx_cached_attention_int8dot_plain(q, *buffers, q_off, kv_len, d ** -0.5)
        return ca.mx_cached_attention_dmajor_plain(q, *buffers, q_off, kv_len, d ** -0.5, "int8")

    ref = run(tc.buffers)
    assert ref[0].abs().max() == 0 and ref[1].abs().max() > 0 and torch.isfinite(ref.float()).all()
    stale = [t.clone() for t in tc.buffers]
    for t in stale:
        t[..., 141:] = 0
    stale[1][..., 150], stale[3][..., 150] = 255, 255  # in the last visible position's tile
    stale[1][..., 200], stale[3][..., 200] = 255, 255
    assert torch.equal(run(stale), ref)


# -- (f) what the wrappers refuse ------------------------------------------------------------


def test_dmajor_wrappers_reject_what_the_kernels_do_not_take(monkeypatch):
    d, L = 128, 128
    cache = MXLayerKVCache.create(1, 2, L, d, "int8", device="cpu", layout="dmajor")
    q = torch.zeros(1, 4, 1, d, dtype=torch.bfloat16)
    for kw in (dict(window=16), dict(ring=True), dict(softcap=30.0)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ca.cached_attention_any(q, cache, 0, 1, 1.0, **kw)
    with pytest.raises(ValueError, match="sq == 1"):
        ca.mx_cached_attention_int8dot(torch.zeros(1, 4, 2, d, dtype=torch.bfloat16), *cache.buffers, 0, 2, 1.0)
    fp8 = MXLayerKVCache.create(1, 2, L, d, "float8_e4m3", device="cpu", layout="dmajor")
    with pytest.raises(ValueError, match="int8 d-major cache"):
        ca.mx_cached_attention_int8dot(q, *fp8.buffers, 0, 1, 1.0)
    # What only the CUDA kernels refuse, checked before anything is launched.
    monkeypatch.setattr(ca, "on_cuda", lambda *t: True)
    wide = MXLayerKVCache.create(1, 2, L, 256, "int8", device="cpu", layout="dmajor")
    q256 = torch.zeros(1, 4, 1, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d=128"):
        ca.mx_cached_attention_dmajor(q256, *wide.buffers, 0, 1, 1.0, "int8")
    with pytest.raises(ValueError, match="d=128"):
        ca.mx_cached_attention_int8dot(q256, *wide.buffers, 0, 1, 1.0)
    short = MXLayerKVCache.create(1, 2, 96, d, "int8", device="cpu", layout="dmajor")
    with pytest.raises(ValueError, match="L % 64"):
        ca.mx_cached_attention_dmajor(q, *short.buffers, 0, 1, 1.0, "int8")
    with pytest.raises(ValueError, match="L % 128"):
        ca.mx_cached_attention_int8dot(q, *short.buffers, 0, 1, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ca.mx_cached_attention_dmajor(q, *(t.transpose(2, 3) for t in
                                           MXLayerKVCache.create(1, 2, d, L, "int8", device="cpu").buffers),
                                      0, 1, 1.0, "int8")


# -- (g) K4's and K6's cluster kernel: the shares and the launches -------------------------


@pytest.mark.parametrize("L, P", [(64, 64), (128, 256), (192, 64), (256, 256), (576, 192), (1024, 256),
                                  (1152, 256), (2048, 256), (4096, 512), (8192, 1024), (16384, 2048), (16512, 4096),
                                  (32768, 4096), (131072, 16384), (262144, 32768)])
def test_attention_share_table(L, P):
    """The share a CTA of K4's and K6's kernel takes for each cache length:
    a multiple of 64 that divides JAX's tile or is whole tiles of it, at
    most 8 shares a cache."""
    lt = ca.attention_tile(L)
    assert ca.attention_share(L) == P
    assert P % 64 == 0 and (lt % P == 0 or P % lt == 0) and -(-L // P) <= ca.ATTN_MAX_SHARES


@pytest.mark.parametrize("L, rows, plan", [(256, 4, (256, 256, False)), (256, 64, (256, 256, True)),
                                           (1024, 17, (512, 256, True)), (2048, 256, (1024, 256, True)),
                                           (4096, 256, (1024, 512, False)), (8192, 32, (2048, 1024, False)),
                                           (16384, 4, (2048, 2048, False)), (32768, 4, (2048, 4096, False)),
                                           (65536, 64, (2048, 8192, False)), (131072, 4, (2048, 16384, False)),
                                           (262144, 64, (2048, 32768, False))])
def test_attention_plan(L, rows, plan):
    """Tile, share and row layout: 64-row tiles where the rows fill more than
    16 and a 64-row share's scores fit shared memory (L <= 2048)."""
    assert ca.attention_plan(L, rows) == plan


@pytest.mark.parametrize("L", [4194368, 100, 0])
def test_attention_plan_refuses(L):
    """A cache whose share would pass ATTN_MAX_SHARE (L > 4194304, the first
    such multiple of 64 here), or that is not a multiple of 64 positions, is
    refused with a ValueError."""
    with pytest.raises(ValueError):
        ca.attention_plan(L, 4)


@pytest.mark.parametrize("layout", ["seq", "dmajor"])
def test_attention_share_is_a_function_of_L_alone(monkeypatch, layout):
    """The tile and share the wrappers launch with depend on the cache length
    alone, not on the batch, the query length or kv_len; the grid takes
    every share of L for a tensor kv_len and only those below a numeric
    one; the row layout follows the rows; a numeric q_off and kv_len go as
    numbers, tensors as pointers."""
    launches = []
    monkeypatch.setattr(ca, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ca.cuda_lib, "launch", lambda src, fn, *a, **kw: launches.append((src, a)))
    for L in (256, 1024, 8192):
        lt, P = ca.attention_tile(L), ca.attention_share(L)
        for b, sq, kv in ((1, 1, 700), (4, 64, torch.tensor([65, 300, 900, 1000])), (32, 1, L), (2, 5, 1)):
            cache = MXLayerKVCache.create(b, 2, L, 128, "int8", device="cpu", layout=layout)
            q = torch.zeros(b, 4, sq, 128, dtype=torch.bfloat16)
            launches.clear()
            fn = ca.mx_cached_attention if layout == "seq" else ca.mx_cached_attention_dmajor
            fn(q, *cache.buffers, 0, kv, 1.0, "int8")
            ((src, a),) = launches
            want = -(-L // P) if isinstance(kv, torch.Tensor) else max(1, -(-min(kv, L) // P))
            assert src == ("mx_attention" if layout == "seq" else "mx_attention_dmajor")
            assert (a[14], a[16], a[17], a[18], a[19]) == (L, lt, P, want, int(sq * 2 > 16 and P <= 256))
            assert (a[5] is None) == (not isinstance(kv, torch.Tensor))
