"""B13 (``csrc/mx_mla.cu``, ``cuda_mla.mx_mla_attention``) on the card,
against its plain version; imports neither JAX nor flax, so the machine with
the card can collect it.  Every case needs an NVIDIA GPU (marker ``gpu``) and
skips elsewhere.  The tests directory's ``conftest.py`` imports JAX, so on a
machine without JAX run this file without it:

    python -m pytest tests/test_torch_gpu_mla.py -m gpu -q --noconftest

Shapes: r = 512, dr = 64 (the kernel's widths), n = 16 and 32 heads, decode
and prefill (rows not a multiple of the 64-row tile), every cache format,
visible prefixes at and around the chunk boundaries of ``mla_chunk(L)`` and
a batch row that sees no key.  Tolerances: abs <= 2e-2 of the plain version
(fp32 sums in another order; the model check's kernel tolerance) and each
row's relative L2 error <= 1.2e-2 (``chip_smoke.B13_ROW_REL``, which a combine
that drops a last chunk of one position fails); a row with
no visible key exactly 0; a row's bytes the same alone, in company and as
the last row of a prefill (the kernel's row invariance), and from one call
to the next (the combine's tickets reset); a numeric kv_len (the grid cut
to its chunks) the same bytes as a tensor.
"""

import pytest
import torch

from torchmx_tpu_torch.models.deepseek import MLACache, MXMLACache
from torchmx_tpu_torch.ops import cuda_lib, cuda_mla

FORMATS = ("bfloat16", "float8_e4m3", "float6_e3m2", "float6_e2m3", "int8", "float4_e2m1")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cache(elem, b, L, seed):
    """A latent cache of ``elem`` written at every position from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = torch.randn(b, L, 512, generator=g, device="cuda").to(torch.bfloat16)
    rot = torch.randn(b, L, 64, generator=g, device="cuda").to(torch.bfloat16)
    cache = MLACache.create(b, L, 512, 64, device="cuda") if elem == "bfloat16" else \
        MXMLACache.create(b, L, 512, 64, elem, device="cuda")
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
