"""K6 (``csrc/mx_attention_dmajor.cu``, ``cuda_attention.mx_cached_attention_dmajor``)
on the card, against its plain version and against K4; imports neither JAX
nor flax, so the machine with the card can collect it.  Every case needs an
NVIDIA GPU (marker ``gpu``) and skips elsewhere.  The tests directory's
``conftest.py`` imports JAX, so on a machine without JAX run this file
without it:

    python -m pytest tests/test_torch_gpu_dmajor.py -m gpu -q --noconftest

Shapes: d = 128, GQA groups of 4 (and 8 heads over 2 KV heads), every cache
format, decode and prefill (16-row and 64-row tiles), visible prefixes at and
around the share edges of ``attention_share(L)`` and a batch row that sees
no key.  Tolerances: abs <= 2e-2 of the plain version at JAX's tile (fp32
sums in another order; the model check's kernel tolerance), each row's
relative L2 error <= ``chip_smoke.K6_ROW_REL`` (which a combine that drops a
last share of one position fails) and the whole output's <=
``chip_smoke.K6_L2_REL``; K4's bytes on every row (one kernel in two
layouts); a row with no visible key exactly 0; a row's bytes the same alone,
in a batch of 32 and as the last row of a prefill (the kernel's row
invariance), from one call to the next, and with a numeric kv_len (the grid
cut to its shares) as with a tensor.
"""

import pytest
import torch

from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_lib

FORMATS = ("float8_e4m3", "int8", "float4_e2m1", "float6_e3m2", "float6_e2m3")
ROW_REL, L2_REL = 1.2e-2, 7e-4  # chip_smoke.K6_ROW_REL, K6_L2_REL


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


def _l2_rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _passes(a, b):
    """K6's gate: abs, the worst row's and the whole output's relative L2 error."""
    return _err(a, b) <= 2e-2 and _row_rel(a, b) <= ROW_REL and _l2_rel(a, b) <= L2_REL


def _holds_k4_invariant(out, args):
    """K6 equals K4 over the seq cache of the same content, bit for bit."""
    seq = [t.transpose(2, 3).contiguous() for t in args[1:5]]
    assert torch.equal(out, ca.mx_cached_attention(args[0], *seq, *args[5:]))


@pytest.mark.gpu
@pytest.mark.parametrize("elem", FORMATS)
@pytest.mark.parametrize("sq", [1, 64, 128])
def test_cuda_dmajor_attention_kernel_matches_plain(cuda_device, elem, sq):
    """K6 against its plain version; against K4 bit for bit."""
    b, hq, hkv, L = 3, 8, 2, 256
    cache = _cache(cuda_device, 4, b, hkv, L, elem)
    q = _queries(cuda_device, 5, b, hq, sq)
    args = _args(cache, q, [0, 128, 0], [sq, 128 + sq, 0], elem)
    out = _launch(args)
    ref = ca.mx_cached_attention_dmajor_plain(*args)
    assert out[2].abs().max().item() == 0  # no visible key
    assert _passes(out, ref)
    if elem in ca.K4_FORMATS:
        _holds_k4_invariant(out, args)


S1024 = ca.attention_share(1024)
EDGES = [S1024 - 1, S1024, S1024 + 1, 2 * S1024 + 1]


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 5, 64], ids=["decode", "prefill sq=5", "prefill sq=64"])
@pytest.mark.parametrize("elem", FORMATS)
def test_cuda_dmajor_share_edges(cuda_device, elem, sq):
    """Visible prefixes at S - 1, S, S + 1 and 2S + 1 of L = 1024's share and
    0: the plain version under the gate, K4's bytes, and exact zeros where a
    row sees nothing."""
    kv = EDGES + [0]
    cache = _cache(cuda_device, 6, len(kv), 8, 1024, elem)
    q = _queries(cuda_device, 7, len(kv), 32, sq)
    args = _args(cache, q, [max(k - sq, 0) for k in kv], kv, elem)
    out = _launch(args)
    ref = ca.mx_cached_attention_dmajor_plain(*args)
    assert torch.isfinite(out.float()).all()
    assert _passes(out, ref)
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
    assert _passes(alone, ca.mx_cached_attention_dmajor_plain(*args))
    assert torch.equal(alone[0], batch[i])
    assert torch.equal(alone[0, :, 0], prefill[0, :, -1])
    assert torch.equal(_launch(args), alone)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64])
def test_cuda_dmajor_numeric_kv_len(cuda_device, sq):
    """Where q_off and kv_len are numbers the wrapper launches only the
    shares below kv_len: the same bytes as with (b,) tensors."""
    cache = _cache(cuda_device, 11, 3, 8, 1024, "int8")
    q = _queries(cuda_device, 12, 3, 32, sq)
    for kv in (1, S1024, S1024 + 1, 700, 1024):
        q_off = max(kv - sq, 0)
        args = _args(cache, q, [q_off] * 3, [kv] * 3, "int8")
        assert torch.equal(_launch((*args[:5], q_off, kv, *args[7:])), _launch(args))


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "prefill sq=64"])
@pytest.mark.parametrize("extra", [1, S1024 + 1], ids=["kv=S+1", "kv=2S+1"])
def test_cuda_dmajor_gate_catches_dropped_share(cuda_device, sq, extra):
    """At kv_len = S + 1 and 2S + 1 (the last live share one position long)
    the sound kernel passes the gate and a combine that drops the last live
    share fails it, one batch row alone; where a tile has one live share the
    fault changes nothing."""
    kv = S1024 + extra
    cache = _cache(cuda_device, 13, 1, 8, 1024, "int8")
    q = _queries(cuda_device, 14 + sq, 1, 32, sq)
    args = _args(cache, q, [kv - sq], [kv], "int8")
    good = _launch(args)
    ref = ca.mx_cached_attention_dmajor_plain(*args)
    drop = _launch(args, drop_last_share=True)
    assert _passes(good, ref) and not _passes(drop, ref)
    short = _args(cache, q[..., -1:, :], [S1024 - 2], [S1024 - 1], "int8")
    assert torch.equal(_launch(short, drop_last_share=True), _launch(short))
