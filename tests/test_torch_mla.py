"""The port's MLA attention, latent caches and the kernels of the DeepSeek
slice held against the JAX package on the same numpy inputs (JAX on the
CPU, its Pallas kernels in interpret mode): the fp4 layout rule (ROADMAP
C.4), the latent caches' bytes in every format and layout, the plain
versions of B13 (``mx_mla_attention``), B14 (``mx_mla_attention_int8dot``)
and B7 (``mx_matmul_fp4_pair``) against the Pallas kernels they replace,
the MLA dispatch's routes, the row invariance of the plain reductions
(ROADMAP C.1), how B13's launches cover a call under its workspace cap, and
B14's tiling.  The kernels against their plain versions on a card:
``tests/test_torch_gpu_mla.py`` (JAX-free).

Tolerances: cache buffers, layouts and q codes bit-equal; plain B13 against
the JAX kernel atol = rtol = 2e-2 (the JAX kernel takes one tile of 256
positions, the port chunks of ``mla_chunk(L)`` combined in chunk order and
tiles of 32 inside each: p rounds to bf16 against other running maxima),
the JAX tests' own tolerance, and the same against float64 exact attention
with the visible prefix at and around the chunk boundaries; plain B13's
rows bit-equal alone, in company and inside a prefill; plain B14 (JAX's
tile, its default) equal to the JAX kernel bit for bit, at and around the
tile edges, and SQNR above 30 dB against exact attention; plain B7 rel <=
1e-2 (K3's).
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.config import MXConfig as JMXConfig
from torchmx_tpu.config import QLinearConfig as JQLin
from torchmx_tpu.layers.linear import MXInferenceLinear as JLinear
from torchmx_tpu.models import deepseek as jds
from torchmx_tpu.mx_array import MXArray
from torchmx_tpu.mx_array import quantize_mx as jquantize_mx
from torchmx_tpu.ops import pallas_matmul as jpm
from torchmx_tpu.ops import pallas_mla as jmla
from torchmx_tpu_torch import env_variables as env
from torchmx_tpu_torch.config import MXConfig, QLinearConfig
from torchmx_tpu_torch.layers.linear import MXInferenceLinear
from torchmx_tpu_torch.models import deepseek as tds
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_lib, cuda_mla, cuda_moe
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
from torchmx_tpu_torch.ops.cuda_norm import rms_norm_plain

torch.set_num_threads(1)

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


# -- the fp4 layout rule (ROADMAP C.4) ----------------------------------------------------------


@pytest.mark.parametrize("K", [128, 512, 1408, 2048, 2816, 4096, 11264, 14336])
def test_fp4_layout_rule_matches_jax(K):
    """An fp4 weight of ``K`` inputs takes JAX's layout (halves only when K %
    512 == 0, else pair), byte for byte; on the CPU the pair layout's kernel
    is B7's plain version."""
    w = bf16(np.random.default_rng(K).standard_normal((64, K)) * 0.05)
    jq = JQLin(weights_config=JMXConfig("float4_e2m1"), activations_config=JMXConfig("float8_e4m3"))
    tq = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    jw = JLinear.from_weights(j_bf16(w), None, jq).weight.get_value()
    tw = MXInferenceLinear(MXTensor.to_mx(t_bf16(w), "float4_e2m1", 32), None, tq).weight
    assert tw.fp4_pack == jw.fp4_pack == ("halves" if K % 512 == 0 else "pair")
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(tw.scale_e8m0.numpy(), np.asarray(jw.scale_e8m0))


# -- row invariance of the plain reductions (ROADMAP C.1) -----------------------------------------


@pytest.mark.parametrize("what", ["rmsnorm", "router-bf16", "router-f32"])
def test_plain_reductions_are_row_invariant(what):
    """A row's bytes from the plain RMSNorm and the plain router (both
    modes) do not depend on how many rows share the call, at every count
    from 1 to 64."""
    g = torch.Generator().manual_seed(17)
    x = torch.randn(64, 2048, generator=g).to(torch.bfloat16)
    if what == "rmsnorm":
        w = (1 + 0.1 * torch.randn(2048, generator=g)).to(torch.bfloat16)
        fn = lambda t: rms_norm_plain(t, w, 1e-5)  # noqa: E731
    else:
        gw = (torch.randn(64, 2048, generator=g) * 2048 ** -0.5).to(torch.bfloat16)
        fn = lambda t: cuda_moe.mx_router_logits_plain(t, gw, f32=what.endswith("f32"))  # noqa: E731
    full = fn(x)
    assert [k for k in range(1, 65) if not torch.equal(fn(x[:k]), full[:k])] == []


@pytest.mark.parametrize("elem", ["int8", "float4_e2m1", "bfloat16"])
def test_plain_b13_is_row_invariant(elem):
    """A query row's bytes from plain B13 are the same computed alone (b = 1,
    sq = 1), as the last row of a prefill of 64 positions, and in a batch of
    8 rows with other prefixes: the chunks and tiles sit at absolute
    positions, the dots are summed exactly and a tile's sum by a pairwise
    tree.  L = 1024: eight chunks of 128."""
    L, r, dr, n, P, target = 1024, 512, 64, 4, 700, 3
    rng = np.random.default_rng(21)
    lat = t_bf16(rng.standard_normal((8, L, r)) * 0.3)
    rot = t_bf16(rng.standard_normal((8, L, dr)) * 0.3)
    if elem == "bfloat16":
        cache = tds.MLACache(lat, rot)
    else:
        cache = tds.MXMLACache.create(8, L, r, dr, elem)
        cache.write(lat, rot, 0)
    bufs = cache.buffers if elem != "bfloat16" else (cache.latent, cache.latent, cache.k_rot, cache.k_rot)
    ql = t_bf16(rng.standard_normal((8, 64 * n, r)) * 0.3)
    qr = t_bf16(rng.standard_normal((8, 64 * n, dr)) * 0.3)
    sm = (128 + dr) ** -0.5

    def b13(rows, idx, q_off, kv_len):
        return cuda_mla.mx_mla_attention_plain(ql[idx, -rows:], qr[idx, -rows:], *(t[idx] for t in bufs),
                                               torch.tensor(q_off), torch.tensor(kv_len), sm, elem, n)

    kv = [1024, 3, 130, P + 1, 257, 0, 900, 128]
    batch = b13(n, slice(None), [k - 1 if k else 0 for k in kv], kv)
    alone = b13(n, slice(target, target + 1), [P], [P + 1])
    prefill = b13(64 * n, slice(target, target + 1), [P - 63], [P + 1])
    assert torch.equal(alone[0], batch[target])
    assert torch.equal(alone[0], prefill[0, -n:])
    assert torch.equal(batch[5], torch.zeros_like(batch[5]))


# -- the latent caches -------------------------------------------------------------------------

B, R, DR = 2, 64, 64
CACHE_CASES = [("bfloat16", "seq")] + [(e, lay) for e in ("float8_e4m3", "float6_e3m2", "float6_e2m3", "int8")
                                       for lay in ("seq", "dmajor")] + [("float4_e2m1", "seq")]


def _jax_cache(elem, layout, L, r=R, dr=DR):
    if elem == "bfloat16":
        return jds.MLACache.create(B, L, r, dr)
    return jds.MXMLACache.create(B, L, r, dr, elem, 32, layout=layout)


def _port_cache(jc):
    """The port's cache over a JAX cache's bytes."""
    if isinstance(jc, jds.MLACache):
        return tds.MLACache(t_bf16(np.asarray(jc.latent, np.float32)), t_bf16(np.asarray(jc.k_rot, np.float32)))
    bufs = [torch.from_numpy(np.array(getattr(jc, n))) for n in ("lat_data", "lat_scale", "rot_data", "rot_scale")]
    return tds.MXMLACache(*bufs, jc.elem_dtype_name, jc.block_size, jc.layout)


def _same_buffers(tc, jc):
    names = ("latent", "k_rot") if isinstance(jc, jds.MLACache) else ("lat_data", "lat_scale", "rot_data", "rot_scale")
    for name, t in zip(names, tc.buffers):
        j = np.asarray(getattr(jc, name))
        if j.dtype.name == "bfloat16":
            np.testing.assert_array_equal(to_np(t), np.asarray(j, np.float32), err_msg=name)
        else:
            assert str(t.dtype).split(".")[-1] == str(j.dtype), name
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("per_row", [False, True], ids=["int-pos", "per-row-pos"])
@pytest.mark.parametrize("elem,layout", CACHE_CASES, ids=[f"{e}-{lay}" for e, lay in CACHE_CASES])
def test_latent_cache_write_matches_jax(elem, layout, per_row):
    """A prefill of 5 positions, then a decode write at position 5 (or at
    per-row positions 5 and 9): every buffer bit-equal to JAX's, and
    ``read()`` equal too."""
    rng = np.random.default_rng(3)
    lat, rot = bf16(rng.standard_normal((B, 5, R))), bf16(rng.standard_normal((B, 5, DR)) * 3)
    jc = _jax_cache(elem, layout, 32)
    tc = tds.MLACache.create(B, 32, R, DR) if elem == "bfloat16" else \
        tds.MXMLACache.create(B, 32, R, DR, elem, layout=layout)
    jc = jc.write(j_bf16(lat), j_bf16(rot), 0)
    tc.write(t_bf16(lat), t_bf16(rot), 0)
    lat1, rot1 = bf16(rng.standard_normal((B, 1, R)) * 0.01), bf16(rng.standard_normal((B, 1, DR)))
    pos = np.array([5, 9], np.int32) if per_row else 5
    jc = jc.write(j_bf16(lat1), j_bf16(rot1), jnp.asarray(pos) if per_row else pos)
    tc.write(t_bf16(lat1), t_bf16(rot1), torch.from_numpy(pos) if per_row else pos)
    _same_buffers(tc, jc)
    for t, j in zip(tc.read(), jc.read()):
        np.testing.assert_array_equal(to_np(t), np.asarray(j, np.float32))


def test_latent_cache_layout_rule(monkeypatch):
    """``layout=None`` takes ``TORCHMX_KV_LAYOUT`` (warning when the int8-dot
    flag is off), fp4 stays seq, fp4 d-major is refused; the engine's hooks
    (``buffers``, ``clone``, ``max_len``) hold in both layouts."""
    monkeypatch.setattr(env, "TORCHMX_KV_LAYOUT", "dmajor")
    monkeypatch.setattr(env, "TORCHMX_ATTN_INT8_DOT", "0")
    with pytest.warns(UserWarning, match="d-major"):
        c = tds.MXMLACache.create(1, 64, R, DR, "int8")
    assert c.layout == "dmajor" and c.max_len == 64 and c.lat_data.shape == (1, R, 64)
    assert tds.MXMLACache.create(1, 64, R, DR, "float4_e2m1").layout == "seq"
    with pytest.raises(ValueError, match="seq layout"):
        tds.MXMLACache.create(1, 64, R, DR, "float4_e2m1", layout="dmajor")
    monkeypatch.setattr(env, "TORCHMX_ATTN_INT8_DOT", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c = tds.MXMLACache.create(1, 64, R, DR, "int8")
    twin = c.clone()
    assert all(a.data_ptr() != b.data_ptr() and torch.equal(a, b) for a, b in zip(c.buffers, twin.buffers))


# -- plain B13 and B14 against the Pallas kernels ---------------------------------------------------

N_HEADS, L_ATTN = 4, 256
MLA_ELEMS = ["bfloat16", "float8_e4m3", "float6_e3m2", "float6_e2m3", "int8", "float4_e2m1"]
MLA_CASES = {"decode": (1, 200, 201), "prefill": (16, 0, 16), "per-row": (1, np.array([3, 250]), np.array([4, 251]))}


def _filled(elem, layout="seq", L=L_ATTN, r=R, dr=DR, seed=11):
    rng = np.random.default_rng(seed)
    lat, rot = bf16(rng.standard_normal((B, L, r)) * 0.3), bf16(rng.standard_normal((B, L, dr)) * 0.3)
    jc = _jax_cache(elem, layout, L, r, dr).write(j_bf16(lat), j_bf16(rot), 0)
    return jc, _port_cache(jc)


def _queries(sq, r=R, dr=DR, seed=12):
    rng = np.random.default_rng(seed)
    return bf16(rng.standard_normal((B, N_HEADS, sq, r)) * 0.3), bf16(rng.standard_normal((B, N_HEADS, sq, dr)) * 0.3)


@pytest.mark.parametrize("case", list(MLA_CASES))
@pytest.mark.parametrize("elem", MLA_ELEMS)
def test_mla_plain_matches_pallas_kernel(elem, case):
    """The port's dispatch on the CPU (plain B13) against JAX's
    ``mla_cached_attention`` (the Pallas kernel, interpret mode): decode,
    prefill through the cache and per-row positions."""
    sq, q_off, kv_len = MLA_CASES[case]
    jc, tc = _filled(elem)
    ql, qr = _queries(sq)
    sm = (R + DR) ** -0.5
    with jax_env():
        jo = jmla.mla_cached_attention(j_bf16(ql), j_bf16(qr), jc, jnp.asarray(q_off), jnp.asarray(kv_len), sm)
    assert jo is not None
    pos = (lambda v: torch.from_numpy(v)) if isinstance(q_off, np.ndarray) else (lambda v: v)
    eager = cuda_mla.ROUTES["eager"]
    got = cuda_mla.mla_cached_attention(t_bf16(ql), t_bf16(qr), tc, pos(q_off), pos(kv_len), sm)
    assert cuda_mla.ROUTES["eager"] == eager and got.shape == (B, N_HEADS, sq, R)
    np.testing.assert_allclose(to_np(got), np.asarray(jo, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b, rows, n, chunks", [(32, 16, 16, 8), (8, 8192, 16, 1), (32, 1024, 16, 4),
                                                 (3, 65536, 32, 64), (1, 65536, 16, 16)])
def test_b13_launch_groups_cover_the_call(b, rows, n, chunks):
    """B13's launches for a call: each (batch row, query row) in exactly one
    launch, each launch's combine workspace within ``B13_WORKSPACE_BYTES``,
    a group of query rows inside one batch row and starting at a query
    position; one launch wherever the call's workspace fits (a grid of one
    chunk needs none)."""
    row_floats = chunks * (512 + 2) if chunks > 1 else 0
    groups = cuda_mla.b13_launch_groups(b, rows, n, row_floats)
    seen = torch.zeros(b, rows, dtype=torch.int32)
    for i0, i1, r0, r1 in groups:
        assert (i1 - i0) * (r1 - r0) * row_floats * 4 <= cuda_mla.B13_WORKSPACE_BYTES
        assert (r0, r1) == (0, rows) or (i1 == i0 + 1 and r0 % n == 0 and (r1 - r0) % n == 0)
        seen[i0:i1, r0:r1] += 1
    assert bool((seen == 1).all())
    assert (len(groups) == 1) == (b * rows * row_floats * 4 <= cuda_mla.B13_WORKSPACE_BYTES)


def _exact_mla(ql, qr, cache, q_off, kv_len, sm):
    lat, rot = (torch.from_numpy(np.asarray(t, np.float32)).double() for t in cache.read())
    s = (torch.from_numpy(ql).double() @ lat[:, None].transpose(-1, -2)
         + torch.from_numpy(qr).double() @ rot[:, None].transpose(-1, -2)) * sm
    j = torch.arange(lat.shape[1])
    visible = (j[None] < torch.from_numpy(np.minimum(kv_len, q_off + 1))[:, None])[:, None, None]
    return torch.softmax(s.masked_fill(~visible, float("-inf")), -1) @ lat[:, None]


S_ATTN = cuda_mla.mla_chunk(L_ATTN)


@pytest.mark.parametrize("sq", [1, 16], ids=["decode", "prefill"])
@pytest.mark.parametrize("kv", [S_ATTN - 1, S_ATTN, S_ATTN + 1, 2 * S_ATTN + 1])
def test_mla_plain_chunks_match_exact_attention(kv, sq):
    """Plain B13 (through the dispatch) with the visible prefix at and
    around its chunk boundaries (L = 256: four chunks of 64), beside a row
    that sees 251 positions, against float64 attention over the dequantized
    cache with the causal mask of every query position: atol = rtol = 2e-2."""
    jc, tc = _filled("int8")
    ql, qr = _queries(sq)
    kv_len = np.array([kv, 251])
    q_off = kv_len - sq
    sm = (R + DR) ** -0.5
    got = cuda_mla.mla_cached_attention(t_bf16(ql), t_bf16(qr), tc, torch.from_numpy(q_off),
                                        torch.from_numpy(kv_len), sm)
    lat, rot = (torch.from_numpy(np.asarray(t, np.float32)).double() for t in jc.read())
    s = (torch.from_numpy(ql).double() @ lat[:, None].transpose(-1, -2)
         + torch.from_numpy(qr).double() @ rot[:, None].transpose(-1, -2)) * sm
    pos = torch.from_numpy(q_off)[:, None] + torch.arange(sq)  # (b, sq)
    j = torch.arange(lat.shape[1])
    visible = (j <= pos[..., None]) & (j < torch.from_numpy(kv_len)[:, None, None])
    exact = torch.softmax(s.masked_fill(~visible[:, None], float("-inf")), -1) @ lat[:, None]
    np.testing.assert_allclose(to_np(got), exact.numpy(), atol=2e-2, rtol=2e-2)


def test_mla_int8dot_plain_matches_pallas_kernel():
    """Plain B14 at the JAX kernel's own tile (512 at L = 1024: two tiles,
    so the per-tile requantization of p is exercised; the plain version's
    default), per-row positions with one row seeing less than its written
    prefix, against JAX's ``_mla_int8dot_attention``; through the dispatch
    the same bytes, SQNR above 30 dB against exact attention."""
    L, r, dr = 1024, 512, 64
    jc, tc = _filled("int8", "dmajor", L, r, dr, seed=13)
    ql, qr = _queries(1, r, dr, seed=14)
    q_off, kv_len = np.array([900, 1023], np.int32), np.array([700, 1024], np.int32)
    sm = (128 + dr) ** -0.5
    with jax_env(TORCHMX_ATTN_INT8_DOT="1"):
        assert jmla.use_mla_int8dot(jc, 1, r, dr) and cuda_mla.use_mla_int8dot(tc, 1, r, dr)
        jo = jmla.mla_cached_attention(j_bf16(ql), j_bf16(qr), jc, jnp.asarray(q_off), jnp.asarray(kv_len), sm)
        args = (t_bf16(ql), t_bf16(qr), *tc.buffers, torch.from_numpy(q_off), torch.from_numpy(kv_len), sm)
        at_jax_tile = cuda_mla.mx_mla_attention_int8dot_plain(*args, tile=jmla._pick_lt(L))
        via = cuda_mla.mla_cached_attention(t_bf16(ql), t_bf16(qr), tc, torch.from_numpy(q_off),
                                            torch.from_numpy(kv_len), sm)
    err = np.abs(to_np(at_jax_tile) - np.asarray(jo, np.float32)).max()
    assert err <= 2e-2, err
    assert torch.equal(via, cuda_mla.mx_mla_attention_int8dot_plain(*args))
    assert torch.equal(via, at_jax_tile)
    exact = _exact_mla(ql, qr, jc, q_off, kv_len, sm)
    sqnr = 10 * torch.log10(exact.square().sum() / (via.double() - exact).square().sum())
    assert sqnr > 30, float(sqnr)
    # The q codes and scales are JAX's, bit for bit.
    js, jd = jquantize_mx(j_bf16(ql).reshape(B, N_HEADS, r), "int8", r)
    td, tsc = cuda_mla.quantize_q_rows(t_bf16(ql), t_bf16(qr), sm)[:2]
    np.testing.assert_array_equal(tsc.numpy(), (np.asarray(js, np.int32)[..., 0] << 23).view(np.float32) * np.float32(sm))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("L", [256, 1024, 8192])
def test_mla_int8dot_plain_equals_jax_at_tile_edges(L):
    """Plain B14 through the port's dispatch (p requantized once per JAX
    tile, ``_pick_lt(L)``: 256, 512, 2048) against JAX's
    ``mla_cached_attention`` under ``TORCHMX_ATTN_INT8_DOT=1`` (the Pallas
    kernel in interpret mode), bit for bit on the bf16 output, with the
    visible prefix at and around JAX's tile edges (kv_len lt - 1, lt, lt + 1
    or, where lt = L, lt / 2 + 1) and a row that sees less than its written
    prefix (q_off + 1 < kv_len = L); SQNR above 30 dB against exact
    attention."""
    r, dr, b = 512, 64, 4
    lt = jmla._pick_lt(L)
    assert lt == cuda_mla.b14_split(L)[0]
    kv_len = np.array([lt - 1, lt, lt + 1 if lt < L else lt // 2 + 1, L], np.int32)
    q_off = kv_len - 1
    q_off[-1] = (5 * L) // 8
    rng = np.random.default_rng(L)
    lat, rot = bf16(rng.standard_normal((b, L, r)) * 0.3), bf16(rng.standard_normal((b, L, dr)) * 0.3)
    jc = jds.MXMLACache.create(b, L, r, dr, "int8", 32, layout="dmajor").write(j_bf16(lat), j_bf16(rot), 0)
    tc = _port_cache(jc)
    ql = bf16(rng.standard_normal((b, N_HEADS, 1, r)) * 0.3)
    qr = bf16(rng.standard_normal((b, N_HEADS, 1, dr)) * 0.3)
    sm = (128 + dr) ** -0.5
    with jax_env(TORCHMX_ATTN_INT8_DOT="1"):
        jo = jmla.mla_cached_attention(j_bf16(ql), j_bf16(qr), jc, jnp.asarray(q_off), jnp.asarray(kv_len), sm)
        got = cuda_mla.mla_cached_attention(t_bf16(ql), t_bf16(qr), tc, torch.from_numpy(q_off),
                                            torch.from_numpy(kv_len), sm)
    assert torch.equal(got, t_bf16(np.asarray(jo, np.float32)))
    exact = _exact_mla(ql, qr, jc, q_off, kv_len, sm)
    sqnr = 10 * torch.log10(exact.square().sum() / (got.double() - exact).square().sum())
    assert sqnr > 30, float(sqnr)


@pytest.mark.parametrize("L", [128, 256, 384, 1024, 2048, 8192, 32768])
def test_b14_split_is_a_function_of_L(L):
    """B14's tiling: JAX's tile, shares of 128 or 256 positions dividing it,
    at most 8 CTAs a cluster; at the chip check's decode shapes
    (``chip_smoke.MLA_INT8DOT_CASES``: b, n, L) the grid has more CTAs than
    the ``ceil(n / 16) b`` of the kernel before the cluster."""
    lt, P = cuda_mla.b14_split(L)
    assert lt == jmla._pick_lt(L) and lt % P == 0 and 1 <= lt // P <= 8 and P in (128, 256)
    for b, n, L_case in ((1, 16, 1024), (32, 16, 1024), (32, 16, 256), (8, 32, 8192)):
        lt_c, P_c = cuda_mla.b14_split(L_case)
        ctas = (L_case // lt_c) * (lt_c // P_c) * -(-n // (16 if n <= 16 else 32)) * b
        assert ctas > -(-n // 16) * b


def test_mla_int8dot_plain_skips_hidden_positions():
    """A stale NaN scale (255) past a row's prefix changes nothing in plain
    B14 (the JAX kernel would give NaN there: the port's standing decision)."""
    L, r, dr = 256, 512, 64
    _, tc = _filled("int8", "dmajor", L, r, dr, seed=15)
    ql, qr = _queries(1, r, dr, seed=16)
    args = [t_bf16(ql), t_bf16(qr), *tc.buffers, torch.tensor([40, 100]), torch.tensor([41, 101]), 0.1]
    ref = cuda_mla.mx_mla_attention_int8dot_plain(*args)
    args[3][:, :, 120], args[5][:, :, 130] = 255, 255
    assert torch.equal(cuda_mla.mx_mla_attention_int8dot_plain(*args), ref) and torch.isfinite(ref.float()).all()


def test_mla_dispatch_routes():
    """Where JAX takes its eager route the port does too, and counts it: a
    d-major cache without the int8-dot flag, a block size of 64; the seq
    layout and the d-major decode with the flag take the kernels."""
    ql, qr = _queries(2, 512, 64, seed=18)
    q = (t_bf16(ql), t_bf16(qr))
    before = cuda_mla.ROUTES["eager"]
    seq = tds.MXMLACache.create(B, 128, 512, 64, "int8", layout="seq")
    dmaj = tds.MXMLACache.create(B, 128, 512, 64, "int8", layout="dmajor")
    blk64 = tds.MXMLACache.create(B, 128, 512, 64, "int8", block_size=64, layout="seq")
    for c in (seq, dmaj, blk64):
        c.write(torch.randn(B, 2, 512).to(torch.bfloat16), torch.randn(B, 2, 64).to(torch.bfloat16), 0)
    cuda_mla.mla_cached_attention(*q, seq, 0, 2, 0.1)
    assert cuda_mla.ROUTES["eager"] == before
    cuda_mla.mla_cached_attention(*q, dmaj, 0, 2, 0.1)
    cuda_mla.mla_cached_attention(*q, blk64, 0, 2, 0.1)
    assert cuda_mla.ROUTES["eager"] == before + 2
    with jax_env(TORCHMX_ATTN_INT8_DOT="1"):
        cuda_mla.mla_cached_attention(q[0][:, :, 1:], q[1][:, :, 1:], dmaj, 1, 2, 0.1)
    assert cuda_mla.ROUTES["eager"] == before + 2


# -- plain B7 against the Pallas kernel ----------------------------------------------------------


@pytest.mark.parametrize("act_fq", [None, "float8_e4m3", "int8"])
def test_fp4_pair_plain_matches_pallas_kernel(act_fq):
    """Plain B7 against ``_pallas_matmul_fp4`` (interpret mode) at the
    shared-expert down shape's K (2816, the pair layout, bk 256)."""
    M, K, N = 16, 2816, 128
    rng = np.random.default_rng(6)
    x = bf16(rng.standard_normal((M, K)))
    w = bf16(rng.standard_normal((N, K)) * 0.05)
    jw = MXArray.to_mx(j_bf16(w), "float4_e2m1", 32).T
    tw = MXTensor.to_mx(t_bf16(w), "float4_e2m1", 32).T
    assert jw.fp4_pack == tw.fp4_pack == "pair"
    ref = np.asarray(jpm._pallas_matmul_fp4(j_bf16(x), jw.data, jw.scale_e8m0, 128, 256, jnp.bfloat16, act_fq),
                     np.float32)
    got = kf.mx_matmul_fp4_pair(t_bf16(x), tw.data, tw.scale_e8m0, act_fq)
    assert float(np.abs(to_np(got) - ref).max() / np.abs(ref).max()) <= 1e-2
    np.testing.assert_array_equal(to_np(kf.dequantize_fp4_pair(tw.data, tw.scale_e8m0)),
                                  np.asarray(jw.to_dtype(jnp.bfloat16), np.float32))
