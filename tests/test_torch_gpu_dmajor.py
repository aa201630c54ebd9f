"""K6 (``csrc/mx_attention_dmajor.cu``, ``cuda_attention.mx_cached_attention_dmajor``)
on the card, against its plain version and against K4; imports neither JAX
nor flax, so the machine with the card can collect it.  Every case needs an
NVIDIA GPU (marker ``gpu``) and skips elsewhere.  The tests directory's
``conftest.py`` imports JAX, so on a machine without JAX run this file
without it:

    python -m pytest tests/test_torch_gpu_dmajor.py -m gpu -q --noconftest

Shapes: d = 128, GQA groups of 4 (and 8 heads over 2 KV heads), every cache
format, decode and prefill (one 16-row tile and 64-row tiles), visible
prefixes at and around the chunk boundaries of ``k6_chunk(L)`` and a batch
row that sees no key.  Tolerances: abs <= 2e-2 of the plain version (fp32
sums in another order; the model check's kernel tolerance) and each row's
relative L2 error <= 1.2e-2 (``chip_smoke.K6_ROW_REL``, which a combine that
drops a last chunk of one position fails); K4's bytes on every row whose
visible prefix lies in one chunk (K6's invariant), abs <= 2e-2 and the row
gate elsewhere; a row with no visible key exactly 0; a row's bytes the same
alone, in a batch of 32 and as the last row of a prefill (the kernel's row
invariance), from one call to the next (the combine's tickets reset), with
a numeric kv_len (the grid cut to its chunks) as with a tensor, and under
the workspace cap's launch groups.
"""

import pytest
import torch

from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_lib

FORMATS = ("float8_e4m3", "int8", "float4_e2m1", "float6_e3m2", "float6_e2m3")
ROW_REL = 1.2e-2  # chip_smoke.K6_ROW_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cache(device, seed, b, hkv, L, elem, d=128):
    """Random K/V written into a d-major cache through the port's own write
    path (K1, the fp4 d-halves packing, the store along the last axis)."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    v = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    cache = MXLayerKVCache.create(b, hkv, L, d, elem, device=device, layout="dmajor")
    cache.write(k, v, 0)
    return cache


def _queries(device, seed, b, hq, sq, d=128):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, hq, sq, d, generator=g).to(torch.bfloat16).to(device)


def _args(cache, q, q_off, kv_len, elem):
    dev = q.device
    return (q, *cache.buffers, torch.tensor(q_off, dtype=torch.int32, device=dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev), q.shape[3] ** -0.5, elem)


def _launch(args, **kw):
    """K6 on args, asserting that the call launches the kernel once."""
    before = cuda_lib.LAUNCHES["mx_cached_attention_dmajor"]
    out = ca.mx_cached_attention_dmajor(*args, **kw)
    assert cuda_lib.LAUNCHES["mx_cached_attention_dmajor"] == before + 1
    return out


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _row_rel(a, b):
    """The worst row's relative L2 error (a row of b that is all 0 must match exactly)."""
    num = (a.double() - b.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / b.double().norm(dim=-1)).max().item()


def _one_chunk_rows(args):
    """(b, hq, sq) bool: the rows whose visible prefix lies in one chunk."""
    q, q_off, kv_len = args[0], args[5], args[6]
    pos = q_off[:, None] + torch.arange(q.shape[2], device=q.device)[None]
    visible = torch.minimum(kv_len[:, None], pos + 1)
    return (visible <= ca.k6_chunk(args[1].shape[3]))[:, None, :].expand(q.shape[:3])


def _holds_k4_invariant(out, args):
    """K6's invariant against K4 over the seq cache of the same content."""
    seq = [t.transpose(2, 3).contiguous() for t in args[1:5]]
    k4 = ca.mx_cached_attention(args[0], *seq, *args[5:])
    one = _one_chunk_rows(args)
    assert torch.equal(out[one], k4[one])
    assert _err(out, k4) <= 2e-2 and _row_rel(out, k4) <= ROW_REL


@pytest.mark.gpu
@pytest.mark.parametrize("elem", FORMATS)
@pytest.mark.parametrize("sq", [1, 64, 128])
def test_cuda_dmajor_attention_kernel_matches_plain(cuda_device, elem, sq):
    """K6 against its plain version; against K4 under K6's invariant (a
    cache of 256 positions is one chunk, so every row bit for bit)."""
    b, hq, hkv, L = 3, 8, 2, 256
    cache = _cache(cuda_device, 4, b, hkv, L, elem)
    q = _queries(cuda_device, 5, b, hq, sq)
    args = _args(cache, q, [0, 128, 0], [sq, 128 + sq, 0], elem)
    out = _launch(args)
    ref = ca.mx_cached_attention_dmajor_plain(*args)
    assert out[2].abs().max().item() == 0  # no visible key
    assert _err(out, ref) <= 2e-2 and _row_rel(out, ref) <= ROW_REL
    if elem in ca.K4_FORMATS:
        _holds_k4_invariant(out, args)


S1024 = ca.k6_chunk(1024)
EDGES = [S1024 - 1, S1024, S1024 + 1, 2 * S1024 + 1]


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 5, 64], ids=["decode", "prefill sq=5", "prefill sq=64"])
@pytest.mark.parametrize("elem", FORMATS)
def test_cuda_dmajor_chunk_edges(cuda_device, elem, sq):
    """Visible prefixes at S - 1, S, S + 1 and 2S + 1 of L = 1024's chunk and
    0: the plain version within abs 2e-2 and the row gate, K4's invariant,
    and exact zeros where a row sees nothing."""
    kv = EDGES + [0]
    cache = _cache(cuda_device, 6, len(kv), 8, 1024, elem)
    q = _queries(cuda_device, 7, len(kv), 32, sq)
    args = _args(cache, q, [max(k - sq, 0) for k in kv], kv, elem)
    out = _launch(args)
    ref = ca.mx_cached_attention_dmajor_plain(*args)
    assert torch.isfinite(out.float()).all()
    assert _err(out, ref) <= 2e-2 and _row_rel(out, ref) <= ROW_REL
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    if elem in ca.K4_FORMATS:
        _holds_k4_invariant(out, args)


@pytest.mark.gpu
@pytest.mark.parametrize("elem", ["int8", "float8_e4m3", "float4_e2m1"])
@pytest.mark.parametrize("L, target", [(1024, 2 * S1024 + 5), (256, 200)], ids=["L=1024", "L=256"])
def test_cuda_dmajor_row_invariance(cuda_device, elem, L, target):
    """A query row's bytes are the same computed alone (b = 1, sq = 1), in a
    batch of 32 with other prefixes, and as the last position of a prefill
    of 64 over the same cache; and the same again on a second call."""
    b, hq, hkv, i = 32, 32, 8, 5
    cache = _cache(cuda_device, 8, b, hkv, L, elem)
    q = _queries(cuda_device, 9, b, hq, 1)
    kv = [1 + (L - 1) * j // (b - 1) for j in range(b)]
    kv[i] = target
    batch = _launch(_args(cache, q, [k - 1 for k in kv], kv, elem))
    one = MXLayerKVCache(*(t[i:i + 1] for t in cache.buffers), cache.elem_dtype_name, cache.block_size, "dmajor")
    args = _args(one, q[i:i + 1], [target - 1], [target], elem)
    alone = _launch(args)
    pre = _queries(cuda_device, 10, 1, hq, 64)
    pre[:, :, -1] = q[i, :, 0]
    prefill = _launch(_args(one, pre, [target - 64], [target], elem))
    assert _err(alone, ca.mx_cached_attention_dmajor_plain(*args)) <= 2e-2
    assert torch.equal(alone[0], batch[i])
    assert torch.equal(alone[0, :, 0], prefill[0, :, -1])
    assert torch.equal(_launch(args), alone)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64])
def test_cuda_dmajor_numeric_kv_len(cuda_device, sq):
    """Where q_off and kv_len are numbers the wrapper launches only the
    chunks below kv_len: the same bytes as with (b,) tensors."""
    cache = _cache(cuda_device, 11, 3, 8, 1024, "int8")
    q = _queries(cuda_device, 12, 3, 32, sq)
    for kv in (1, S1024, S1024 + 1, 700, 1024):
        q_off = max(kv - sq, 0)
        args = _args(cache, q, [q_off] * 3, [kv] * 3, "int8")
        assert torch.equal(_launch((*args[:5], q_off, kv, *args[7:])), _launch(args))


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "prefill sq=64"])
@pytest.mark.parametrize("extra", [1, S1024 + 1], ids=["kv=S+1", "kv=2S+1"])
def test_cuda_dmajor_gate_catches_dropped_chunk(cuda_device, sq, extra):
    """At kv_len = S + 1 and 2S + 1 (the last live chunk one position long)
    the sound kernel passes the row gate and a combine that drops the last
    live chunk fails it, one batch row alone; where a tile has one live
    chunk the fault changes nothing."""
    kv = S1024 + extra
    cache = _cache(cuda_device, 13, 1, 8, 1024, "int8")
    q = _queries(cuda_device, 14 + sq, 1, 32, sq)
    args = _args(cache, q, [kv - sq], [kv], "int8")
    good = _launch(args)
    ref = ca.mx_cached_attention_dmajor_plain(*args)
    drop = _launch(args, drop_last_chunk=True)
    assert _row_rel(good, ref) <= ROW_REL < _row_rel(drop, ref)
    short = _args(cache, q[..., -1:, :], [S1024 - 2], [S1024 - 1], "int8")
    assert torch.equal(_launch(short, drop_last_chunk=True), _launch(short))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(3, 4, 1024), (1, 130, 1024)], ids=["batch groups", "row groups"])
def test_cuda_dmajor_workspace_cap(cuda_device, monkeypatch, case):
    """A call whose combine workspace would pass K6_WORKSPACE_BYTES runs as
    several launches over groups of batch rows or of query positions: the
    same bytes as one launch."""
    b, sq, L = case
    hq, kv = 32, L
    cache = _cache(cuda_device, 15, b, 8, L, "int8")
    q = _queries(cuda_device, 16, b, hq, sq)
    args = _args(cache, q, [kv - sq] * b, [kv] * b, "int8")
    one = _launch(args)
    row_floats = -(-L // ca.k6_chunk(L)) * (128 + 2)
    cap = (hq * sq * row_floats if b > 1 else hq * 40 * row_floats) * 4  # one batch row / 40 positions
    monkeypatch.setattr(ca, "K6_WORKSPACE_BYTES", cap)
    groups = ca.k6_launch_groups(b, hq, sq, row_floats)
    assert len(groups) == (b if b > 1 else 4)
    before = cuda_lib.LAUNCHES["mx_cached_attention_dmajor"]
    assert torch.equal(ca.mx_cached_attention_dmajor(*args), one)
    assert cuda_lib.LAUNCHES["mx_cached_attention_dmajor"] == before + len(groups)
