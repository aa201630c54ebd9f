"""B13 (``csrc/mx_mla.cu``, ``cuda_mla.mx_mla_attention``), B14
(``csrc/mx_mla_int8dot.cu``, ``cuda_mla.mx_mla_attention_int8dot``) and B7
(``cuda_matmul_formats.mx_matmul_fp4_pair``, Moonlight's shared-expert
down_proj) on the card, against their plain versions; imports neither JAX nor
flax, so the machine with the card can collect it.  Every case needs an
NVIDIA GPU (marker ``gpu``) and skips elsewhere.  The tests directory's
``conftest.py`` imports JAX, so on a machine without JAX run this file
without it:

    python -m pytest tests/test_torch_gpu_mla.py -m gpu -q --noconftest

B13.  Shapes: r = 512, dr = 64 (the kernel's widths), n = 16 and 32 heads,
decode and prefill (rows not a multiple of the 64-row tile), every cache
format, visible prefixes at and around the chunk boundaries of
``mla_chunk(L)`` and a batch row that sees no key.  Tolerances: abs <= 2e-2
of the plain version (fp32 sums in another order; the model check's kernel
tolerance) and each row's relative L2 error <= 1.2e-2
(``chip_smoke.B13_ROW_REL``, which a combine that drops a last chunk of one
position fails); a row with no visible key exactly 0; a row's bytes the same
alone, in company and as the last row of a prefill (the kernel's row
invariance), and from one call to the next (the combine's tickets reset); a
numeric kv_len (the grid cut to its chunks) the same bytes as a tensor.

B14.  Shapes: ``chip_smoke.MLA_INT8DOT_CASES`` (decode at n = 16 over 256
and 1024 positions, n = 32 over 8192) and the edges of its tiles (JAX's
``_pick_lt(L)``) and of its CTAs' shares (``cuda_mla.b14_split``) at L =
256, 1024 and 8192, 40 heads (two head groups), tiles of 128 (one CTA a
cluster).  Tolerances: abs <= 2e-2 of
the plain version (fp32 sums in another order, rare ties of the requantized
p) and each row's relative L2 error <= ``chip_smoke.B14_ROW_REL`` (which the
planted dropped-tile fault fails); a row with no visible key exactly 0; a
row's bytes the same alone and in company, from one call to the next and
with a numeric kv_len as with a tensor; q's codes and scales, quantized in
the kernel's prologue, equal to ``quantize_q_rows``' bit for bit; a stale
scale of 255 past a row's prefix changes nothing.

B7 (moved from ``tests/test_torch_mla.py``): rel <= 1e-2 of the plain
version (K3's tolerance), and a row's bytes the same at every row count.
"""

import numpy as np
import pytest
import torch

from torchmx_tpu_torch.models.deepseek import MLACache, MXMLACache
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_lib, cuda_mla
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
from torchmx_tpu_torch.ops.backend import plain_path

FORMATS = ("bfloat16", "float8_e4m3", "float6_e3m2", "float6_e2m3", "int8", "float4_e2m1")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cache(elem, b, L, seed, layout="seq"):
    """A latent cache of ``elem`` written at every position from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = torch.randn(b, L, 512, generator=g, device="cuda").to(torch.bfloat16)
    rot = torch.randn(b, L, 64, generator=g, device="cuda").to(torch.bfloat16)
    cache = MLACache.create(b, L, 512, 64, device="cuda") if elem == "bfloat16" else \
        MXMLACache.create(b, L, 512, 64, elem, layout=layout, device="cuda")
    cache.write(lat, rot, 0)
    return cache


def _tensors(cache, elem):
    return cache.buffers if elem != "bfloat16" else (cache.latent, cache.latent, cache.k_rot, cache.k_rot)


def _queries(b, n, sq, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ql = (torch.randn(b, sq * n, 512, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    qr = (torch.randn(b, sq * n, 64, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    return ql, qr


def _both(elem, cache, ql, qr, q_off, kv_len, n, sm=192 ** -0.5):
    dev = ql.device
    args = (ql, qr, *_tensors(cache, elem), torch.tensor(q_off, dtype=torch.int32, device=dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev), sm, elem, n)
    before = cuda_lib.LAUNCHES["mx_mla_attention"]
    got = cuda_mla.mx_mla_attention(*args)
    assert cuda_lib.LAUNCHES["mx_mla_attention"] == before + 1
    return got, cuda_mla.mx_mla_attention_plain(*args), args


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


ROW_REL = 1.2e-2  # chip_smoke.B13_ROW_REL


def _row_rel(a, b):
    """The worst row's relative L2 error (a row of b that is all 0 must match exactly)."""
    num = (a.double() - b.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / b.double().norm(dim=-1)).max().item()


S1024 = cuda_mla.mla_chunk(1024)
# (label, b, n, L, sq, kv_len of each row): kv_len at S - 1, S, S + 1 and 2S + 1 of L = 1024's
# chunk, and 0 (no visible key); decode at n = 16 and 32, prefill of 5 and 3 positions (80 and
# 96 rows, not multiples of 64), and an admission of 130 positions at L = 256.
CASES = [("decode chunk edges n=16", 5, 16, 1024, 1, [S1024 - 1, S1024, S1024 + 1, 2 * S1024 + 1, 0]),
         ("decode chunk edges n=32", 4, 32, 1024, 1, [S1024 - 1, S1024 + 1, 2 * S1024 + 1, 1024]),
         ("prefill sq=5 n=16", 3, 16, 1024, 5, [S1024 + 2, 5, 2 * S1024 + 3]),
         ("prefill sq=3 n=32", 2, 32, 1024, 3, [S1024, 700]),
         ("admission sq=130 L=256", 1, 16, 256, 130, [200])]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("elem", FORMATS)
def test_b13_matches_plain(cuda_device, elem, case):
    """B13 against its plain version, abs <= 2e-2 and each row's relative
    L2 error <= ROW_REL, one launch a call; a batch row that sees no key
    outputs exactly 0."""
    _, b, n, L, sq, kv = case
    cache = _cache(elem, b, L, seed=L + b)
    ql, qr = _queries(b, n, sq, seed=sq * n)
    q_off = [max(k - sq, 0) for k in kv]
    got, ref, _ = _both(elem, cache, ql, qr, q_off, kv, n)
    assert torch.isfinite(got.float()).all()
    assert _err(got, ref) <= 2e-2
    assert _row_rel(got, ref) <= ROW_REL
    for i, k in enumerate(kv):
        if k == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))


@pytest.mark.gpu
@pytest.mark.parametrize("elem", ["int8", "bfloat16", "float4_e2m1"])
def test_b13_row_invariance(cuda_device, elem):
    """A query row's bytes are the same computed alone (b = 1, sq = 1), in a
    batch of 8 with other prefixes, and as the last position of a prefill of
    64 over the same cache; and the same again on a second call."""
    L, n, P, target = 1024, 16, 700, 3
    cache = _cache(elem, 8, L, seed=5)
    ql, qr = _queries(8, n, 1, seed=6)
    kv = [1024, 3, 130, P + 1, 257, 0, 900, 128]
    batch, _, _ = _both(elem, cache, ql, qr, [k - 1 if k else 0 for k in kv], kv, n)
    one = cache.__class__(*(t[target:target + 1] for t in cache.buffers), *(
        () if elem == "bfloat16" else (cache.elem_dtype_name, cache.block_size, cache.layout)))
    alone, ref, args = _both(elem, one, ql[target:target + 1], qr[target:target + 1], [P], [P + 1], n)
    pre_l, pre_r = _queries(1, n, 64, seed=7)
    pre_l[:, -n:], pre_r[:, -n:] = ql[target], qr[target]
    prefill, _, _ = _both(elem, one, pre_l, pre_r, [P - 63], [P + 1], n)
    assert _err(alone, ref) <= 2e-2
    assert torch.equal(alone[0], batch[target])
    assert torch.equal(alone[0], prefill[0, -n:])
    assert torch.equal(cuda_mla.mx_mla_attention(*args), alone)


@pytest.mark.gpu
def test_b13_planted_faults_bite(cuda_device):
    """The model check's planted faults change the kernel's output where
    they should: V from the rope key everywhere, the combine's dropped chunk
    only where a tile has two live chunks or more."""
    cache = _cache("int8", 2, 1024, seed=9)
    ql, qr = _queries(2, 16, 1, seed=10)
    q_off = [S1024 // 2, 2 * S1024 + S1024 // 2]  # row 1: three live chunks, the last with S/2 + 1 positions
    _, _, args = _both("int8", cache, ql, qr, q_off, [q + 1 for q in q_off], 16)
    good = cuda_mla.mx_mla_attention(*args)
    rot = cuda_mla.mx_mla_attention(*args, v_from_rot=True)
    drop = cuda_mla.mx_mla_attention(*args, drop_last_chunk=True)
    assert _err(rot[0], good[0]) > 0.1 and _err(rot[1], good[1]) > 0.1
    assert torch.equal(drop[0], good[0]) and _err(drop[1], good[1]) > 0.05


@pytest.mark.gpu
def test_b13_numeric_kv_len(cuda_device):
    """Where q_off and kv_len are numbers the wrapper launches only the
    chunks below kv_len: the same bytes as with (b,) tensors."""
    cache = _cache("int8", 3, 1024, seed=11)
    ql, qr = _queries(3, 16, 4, seed=12)
    for kv in (1, S1024, S1024 + 1, 700, 1024):
        q_off = max(kv - 4, 0)
        _, _, args = _both("int8", cache, ql, qr, [q_off] * 3, [kv] * 3, 16)
        got = cuda_mla.mx_mla_attention(*args[:6], q_off, kv, *args[8:])
        assert torch.equal(got, cuda_mla.mx_mla_attention(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "prefill sq=64"])
@pytest.mark.parametrize("extra", [1, S1024 + 1], ids=["kv=S+1", "kv=2S+1"])
def test_b13_gate_catches_dropped_chunk(cuda_device, sq, extra):
    """At kv_len = S + 1 and 2S + 1 (the last live chunk one position long)
    the sound kernel passes the row gate and a combine that drops the last
    live chunk fails it, though its max abs error may stay near 2e-2."""
    kv = S1024 + extra
    cache = _cache("int8", 1, 1024, seed=13)
    ql, qr = _queries(1, 16, sq, seed=14 + sq)
    good, ref, args = _both("int8", cache, ql, qr, [kv - sq], [kv], 16)
    drop = cuda_mla.mx_mla_attention(*args, drop_last_chunk=True)
    assert _row_rel(good, ref) <= ROW_REL < _row_rel(drop, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(3, 4, 1024, 1024), (1, 130, 1024, 700)], ids=["batch groups", "row groups"])
def test_b13_workspace_cap(cuda_device, monkeypatch, case):
    """A call whose combine workspace would pass B13_WORKSPACE_BYTES runs as
    several launches over groups of batch rows or of query rows: the same
    bytes as one launch."""
    b, sq, L, kv = case
    cache = _cache("int8", b, L, seed=15)
    ql, qr = _queries(b, 16, sq, seed=16)
    one, _, args = _both("int8", cache, ql, qr, [kv - sq] * b, [kv] * b, 16)
    row_floats = -(-L // cuda_mla.mla_chunk(L)) * (512 + 2)
    cap = (16 * sq * row_floats if b > 1 else 16 * 40 * row_floats) * 4  # one batch row / 40 positions
    monkeypatch.setattr(cuda_mla, "B13_WORKSPACE_BYTES", cap)
    groups = cuda_mla.b13_launch_groups(b, 16 * sq, 16, row_floats)
    assert len(groups) == (b if b > 1 else 4)
    before = cuda_lib.LAUNCHES["mx_mla_attention"]
    assert torch.equal(cuda_mla.mx_mla_attention(*args), one)
    assert cuda_lib.LAUNCHES["mx_mla_attention"] == before + len(groups)


# -- moved from tests/test_torch_mla.py (there they built the cache through the JAX package) ----------


def _np_cache(elem, layout, L, seed=11, b=2):
    """tests/test_torch_mla.py's ``_filled``: a cache of ``b`` rows written at
    every position from a numpy seed, here through the port's own write."""
    rng = np.random.default_rng(seed)
    lat = torch.from_numpy(rng.standard_normal((b, L, 512)) * 0.3).to(torch.bfloat16).cuda()
    rot = torch.from_numpy(rng.standard_normal((b, L, 64)) * 0.3).to(torch.bfloat16).cuda()
    cache = MLACache.create(b, L, 512, 64, device="cuda") if elem == "bfloat16" else \
        MXMLACache.create(b, L, 512, 64, elem, layout=layout, device="cuda")
    cache.write(lat, rot, 0)
    return cache


def _np_queries(sq, seed=12, b=2, n=4):
    """tests/test_torch_mla.py's ``_queries`` at r = 512, dr = 64."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((b, n, sq, 512)) * 0.3).to(torch.bfloat16).cuda(),
            torch.from_numpy(rng.standard_normal((b, n, sq, 64)) * 0.3).to(torch.bfloat16).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("elem", FORMATS)
def test_cuda_mla_kernel_matches_plain(cuda_device, elem):
    """The dispatch launches B13 once over every seq-layout format and
    agrees with the plain path, abs <= 2e-2."""
    tc = _np_cache(elem, "seq", 256)
    ql, qr = _np_queries(3)
    q_off, kv_len = torch.tensor([0, 200], device=cuda_device), torch.tensor([3, 203], device=cuda_device)
    before = cuda_lib.LAUNCHES["mx_mla_attention"]
    got = cuda_mla.mla_cached_attention(ql, qr, tc, q_off, kv_len, 0.07)
    assert cuda_lib.LAUNCHES["mx_mla_attention"] == before + 1
    with plain_path():
        ref = cuda_mla.mla_cached_attention(ql, qr, tc, q_off, kv_len, 0.07)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_cuda_mla_int8dot_kernel_matches_plain(cuda_device):
    """B14 over an int8 d-major latent of 256 positions, abs <= 2e-2."""
    tc = _np_cache("int8", "dmajor", 256)
    ql, qr = _np_queries(1)
    args = (ql, qr, *tc.buffers, torch.tensor([100, 255], device=cuda_device),
            torch.tensor([101, 256], device=cuda_device), 0.07)
    got = cuda_mla.mx_mla_attention_int8dot(*args)
    assert (got.float() - cuda_mla.mx_mla_attention_int8dot_plain(*args).float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("K", [2816, 160, 896])
@pytest.mark.parametrize("act_fq", [None, "float8_e4m3", "int8"])
def test_cuda_fp4_pair_kernel_matches_plain_and_is_row_invariant(cuda_device, act_fq, K):
    g = torch.Generator().manual_seed(8)
    w = MXTensor.to_mx((torch.randn(256, K, generator=g) * 0.05).to(torch.bfloat16).to(cuda_device),
                       "float4_e2m1").T
    x = torch.randn(130, K, generator=g).to(torch.bfloat16).to(cuda_device)
    full = kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, act_fq)
    ref = kf.mx_matmul_fp4_pair_plain(x, w.data, w.scale_e8m0, act_fq)
    assert ((full.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2
    for k in (1, 17, 64, 65):
        assert torch.equal(kf.mx_matmul_fp4_pair(x[:k].contiguous(), w.data, w.scale_e8m0, act_fq), full[:k])


# -- B14 ------------------------------------------------------------------------------------------

B14_ROW_REL = 5e-3  # chip_smoke.B14_ROW_REL
# chip_smoke.MLA_INT8DOT_CASES: (label, b, n, L, kv_len of each row), the query at kv_len - 1
MLA_RAGGED = [1 + round(i * 1023 / 31) for i in range(32)]
B14_CASES = [("decode b=1 L=1024 kv=700", 1, 16, 1024, [700]),
             ("decode b=32 L=1024 ragged", 32, 16, 1024, MLA_RAGGED),
             ("decode b=32 L=256 kv=65-192", 32, 16, 256, [65 + round(i * 127 / 31) for i in range(32)]),
             ("bench b=8 n=32 L=8192", 8, 32, 8192, [8192] * 8)]


def _b14_edges(L):
    lt, P = cuda_mla.b14_split(L)
    return sorted({e for e in (P - 1, P + 1, lt - 1, lt, lt + 1, 2 * lt - 1, 2 * lt + 1, L) if e <= L} | {0})


B14_CASES += [(f"edges L={L}", len(_b14_edges(L)), 16, L, _b14_edges(L)) for L in (256, 1024, 8192)]
B14_CASES += [("n=40 L=1024", 3, 40, 1024, [1, 513, 1000]), ("L=384 lt=128 C=1", 3, 16, 384, [1, 129, 384])]


def _b14_args(b, n, L, kv, seed, q_off=None):
    """B14's arguments: an int8 d-major latent written at every position, row
    i's query at kv[i] - 1 (or q_off)."""
    cache = _cache("int8", b, L, seed, layout="dmajor")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ql = (torch.randn(b, n, 1, 512, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    qr = (torch.randn(b, n, 1, 64, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    kv_t = torch.tensor(kv, dtype=torch.int32, device="cuda")
    q_t = (kv_t - 1).clamp(min=0) if q_off is None else torch.tensor(q_off, dtype=torch.int32, device="cuda")
    return (ql, qr, *cache.buffers, q_t, kv_t, 192 ** -0.5)


def _b14(args, **kw):
    """B14 on args, asserting that the call launches the kernel once (and no per-row quantize)."""
    before = dict(cuda_lib.LAUNCHES)
    out = cuda_mla.mx_mla_attention_int8dot(*args, **kw)
    after = dict(cuda_lib.LAUNCHES)
    assert after.get("mx_mla_attention_int8dot", 0) == before.get("mx_mla_attention_int8dot", 0) + 1
    assert after.get("mx_quantize_rows", 0) == before.get("mx_quantize_rows", 0)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", B14_CASES, ids=[c[0] for c in B14_CASES])
def test_b14_matches_plain(cuda_device, case):
    """B14 against its plain version, abs <= 2e-2 and each row's relative L2
    error <= B14_ROW_REL, one launch a call; a row with no visible key
    outputs exactly 0; a second launch gives the same bytes."""
    _, b, n, L, kv = case
    args = _b14_args(b, n, L, kv, seed=L + b + n)
    got = _b14(args)
    ref = cuda_mla.mx_mla_attention_int8dot_plain(*args)
    assert torch.isfinite(got.float()).all()
    assert _err(got, ref) <= 2e-2
    assert _row_rel(got, ref) <= B14_ROW_REL
    for i, k in enumerate(kv):
        if k == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))
    assert torch.equal(_b14(args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1024, 8192])
def test_b14_gate_catches_dropped_tile(cuda_device, L):
    """At kv_len = lt + 1 and 2 lt + 1 (the last live tile one position
    long) the sound kernel passes the row gate and a combine that drops the
    last live tile fails it."""
    lt, _ = cuda_mla.b14_split(L)
    for kv in (lt + 1, 2 * lt + 1):
        args = _b14_args(1, 16, L, [kv], seed=kv)
        ref = cuda_mla.mx_mla_attention_int8dot_plain(*args)
        assert _row_rel(_b14(args), ref) <= B14_ROW_REL < _row_rel(_b14(args, drop_last_tile=True), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [256, 1024, 8192])
def test_b14_numeric_kv_len(cuda_device, L):
    """Where q_off and kv_len are numbers the wrapper launches only the
    tiles below kv_len: the same bytes as with (b,) tensors."""
    lt, P = cuda_mla.b14_split(L)
    args = _b14_args(3, 16, L, [L] * 3, seed=L)
    for kv in sorted({1, P, P + 1, lt, min(lt + 1, L), L}):
        tensors = (*args[:6], torch.full((3,), kv - 1, dtype=torch.int32, device=cuda_device),
                   torch.full((3,), kv, dtype=torch.int32, device=cuda_device), args[8])
        assert torch.equal(_b14((*args[:6], kv - 1, kv, args[8])), _b14(tensors))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1024, 8192])
def test_b14_row_invariance(cuda_device, L):
    """A row's bytes are the same computed alone (b = 1) and in a batch of 8
    with other prefixes (one that sees no key), and the same again on a
    second call."""
    target = 3
    kv = [L, 3, 130, 700, 257, 0, 900, 128]
    args = _b14_args(8, 16, L, kv, seed=L + 5)
    batch = _b14(args)
    one = tuple(t[target:target + 1] for t in args[:8]) + (args[8],)
    alone = _b14(one)
    assert torch.equal(alone[0], batch[target])
    assert torch.equal(_b14(one), alone)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 32, 40])
def test_b14_prologue_q_codes(cuda_device, n):
    """The q codes and scales B14 computes in its prologue equal
    ``quantize_q_rows``' (the per-row kernel), bit for bit, over q holding
    zeros, subnormals and large values."""
    args = _b14_args(3, n, 1024, [700, 1, 1024], seed=n)
    for q in args[:2]:
        q.view(-1)[::7] = 0
        q.view(-1)[1::11] *= 2.0 ** -120
        q.view(-1)[2::13] *= 2.0 ** 100
    want = cuda_mla.quantize_q_rows(args[0], args[1], args[8])
    got = tuple(torch.empty_like(t) for t in want)
    _b14(args, q_out=got)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.gpu
def test_b14_skips_hidden_positions(cuda_device):
    """A stale scale of 255 (NaN) past a row's prefix changes nothing: the
    output stays finite and its bytes unchanged."""
    args = list(_b14_args(2, 16, 1024, [41, 700], seed=21))
    ref = _b14(args)
    args[3][:, :, 720], args[5][:, :, 800], args[3][0, 0, 41] = 255, 255, 255
    got = _b14(args)
    assert torch.isfinite(got.float()).all() and torch.equal(got, ref)
