"""K4 (``cuda_attention.mx_cached_attention``) and K6
(``cuda_attention.mx_cached_attention_dmajor``), the two layouts of one
cluster kernel (``csrc/mx_attention_tile.cuh``), on the card against their
plain versions at JAX's tile and against each other; imports neither JAX nor
flax, so the machine with the card can collect it.  Every case needs an
NVIDIA GPU (marker ``gpu``) and skips elsewhere.  The tests directory's
``conftest.py`` imports JAX, so on a machine without JAX run this file
without it:

    python -m pytest tests/test_torch_gpu_attention.py -m gpu -q --noconftest

Shapes: d = 128, GQA groups of 4 (and 8 heads over 2 KV heads), the seq
formats (fp8, fp6 e3m2 and e2m3, int8) and fp4 in the d-major layout,
decode (16-row tiles) and prefill (64-row tiles to L = 2048, 16-row tiles
above), caches of 256 to 32768 positions (shares of two JAX tiles at L =
384 and 1152, of 2048 positions at 16384, and past 16384 shares whose
scores are taken in chunks of 2048: at 16512 shares of 4096 hold 32 JAX
tiles of 128), visible prefixes at and around JAX's
tile, the kernel's share and chunk edges and a batch row that sees no key.
Tolerances: abs <= 2e-2 of the plain version (the model check's kernel
tolerance), each row's relative L2 error <= ``chip_smoke.K4_ROW_REL`` (which
a combine that drops the last share fails) and the whole output's <=
``chip_smoke.K4_L2_REL`` (which p rounded against the 64-position running
maximum fails): the kernel rounds every p against the plain version's
running maximum and differs in fp32 summation order only; K6 equal to K4 bit
for bit on the same cache content; a row with no visible key exactly 0; a
row's bytes the same alone, in a batch of 32, as the last row of a prefill
of 64 (the other row layout), from one call to the next and with a numeric
kv_len as with a tensor; one launch a call.
"""

import pytest
import torch

from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_lib

ROW_REL, L2_REL = 1.2e-2, 7e-4  # chip_smoke.K4_ROW_REL, K4_L2_REL
SEQ_FORMATS = ("float8_e4m3", "int8", "float6_e3m2", "float6_e2m3")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cache(device, seed, b, hkv, L, elem, d=128, layout="seq"):
    """Random K/V written through the port's own write path (K1, the store
    by position)."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    v = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    cache = MXLayerKVCache.create(b, hkv, L, d, elem, device=device, layout=layout)
    cache.write(k, v, 0)
    return cache


def _args(cache, seed, hq, sq, kv_len, elem):
    """Row i's queries are the last sq of its kv_len[i] visible positions."""
    dev = cache.k_data.device
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(len(kv_len), hq, sq, 128, generator=g).to(torch.bfloat16).to(dev)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return (q, *cache.buffers, (kv - sq).clamp(min=0), kv, 128 ** -0.5, elem)


def _launch(args, layout="seq", **kw):
    """K4 (or K6) on args, asserting that the call launches its kernel once."""
    name = "mx_cached_attention" if layout == "seq" else "mx_cached_attention_dmajor"
    before = dict(cuda_lib.LAUNCHES)
    out = (ca.mx_cached_attention if layout == "seq" else ca.mx_cached_attention_dmajor)(*args, **kw)
    after = dict(cuda_lib.LAUNCHES)
    assert after.get(name, 0) == before.get(name, 0) + 1 and sum(after.values()) == sum(before.values()) + 1
    return out


def _plain(args, layout="seq"):
    return (ca.mx_cached_attention_plain if layout == "seq" else ca.mx_cached_attention_dmajor_plain)(*args)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _row_rel(a, b):
    """The worst row's relative L2 error (a row of b that is all 0 must match exactly)."""
    num = (a.double() - b.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / b.double().norm(dim=-1)).max().item()


def _l2_rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _passes(a, b):
    """K4's and K6's gate: abs, the worst row's and the whole output's relative L2 error."""
    return _err(a, b) <= 2e-2 and _row_rel(a, b) <= ROW_REL and _l2_rel(a, b) <= L2_REL


def _dmajor(args):
    """The same arguments over the d-major cache of the same content."""
    return (args[0], *(t.transpose(2, 3).contiguous() for t in args[1:5]), *args[5:])


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64])
def test_cuda_attention_kernel_matches_plain(cuda_device, sq):
    b, hq, hkv, d, L = 2, 8, 2, 128, 256
    cache = _cache(cuda_device, 1, b, hkv, L, "float8_e4m3")
    args = _args(cache, 1, hq, sq, [sq, 150 + sq], "float8_e4m3")
    out, ref = _launch(args), _plain(args)
    assert _passes(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [8, 64, 128])
def test_cuda_attention_kernel_int8_matches_plain(cuda_device, sq):
    b, hq, hkv, d, L = 2, 8, 2, 128, 256
    cache = _cache(cuda_device, 2, b, hkv, L, "int8")
    args = _args(cache, 2, hq, sq, [sq, 128 + sq], "int8")
    out, ref = _launch(args), _plain(args)
    assert _passes(out, ref)


def _edges(L):
    """Prefixes at and around JAX's tile (lt), the kernel's share (P) of L
    and, in a share longer than ``ATTN_CHUNK``, its second chunk, and 0."""
    lt, P, C = ca.attention_tile(L), ca.attention_share(L), ca.ATTN_CHUNK
    chunk = (P + C, P + C + 1) if P > C else ()
    return sorted({min(k, L) for k in (P - 1, P, P + 1, lt - 1, lt, lt + 1, 2 * lt + 1, L, *chunk)}) + [0]


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 5, 64], ids=["decode", "prefill sq=5", "prefill sq=64"])
@pytest.mark.parametrize("L", [256, 384, 1024, 1152, 8192, 16384, 16512, 32768])
@pytest.mark.parametrize("elem", SEQ_FORMATS)
def test_cuda_attention_tile_edges(cuda_device, elem, L, sq):
    """K4 against its plain version at JAX's tile under the gate; exact zeros
    where a row sees nothing; K6 over the d-major cache of the same content
    equal to it bit for bit."""
    kv = _edges(L)
    hkv = 8 if L <= 8192 else 2  # groups of 4 query heads either way; the long caches' host draw kept small
    cache = _cache(cuda_device, 3, len(kv), hkv, L, elem)
    args = _args(cache, 4, 4 * hkv, sq, kv, elem)
    out = _launch(args)
    assert torch.isfinite(out.float()).all()
    assert _passes(out, _plain(args))
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    assert torch.equal(_launch(_dmajor(args), "dmajor"), out)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["seq", "dmajor"])
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "prefill sq=64"])
@pytest.mark.parametrize("L", [1024, 8192, 32768])
def test_cuda_attention_gate_catches_faults(cuda_device, layout, sq, L):
    """One batch row alone, its prefix one position past the second JAX tile
    (L = 1024), past the last share's start (8192) or past the second share
    (32768, shares of two chunks): the sound kernel passes the gate; p
    rounded against the 64-position running maximum and a combine that drops
    the last live share each fail it."""
    lt, P = ca.attention_tile(L), ca.attention_share(L)
    kv = min(2 * lt + 1, L) if L <= 1024 else L - P + 1 if L <= 8192 else 2 * P + 1
    args = _args(_cache(cuda_device, 5, 1, 8, L, "int8", layout=layout), 6 + sq, 32, sq, [kv], "int8")
    ref = _plain(args, layout)
    assert _passes(_launch(args, layout), ref)
    assert not _passes(_launch(args, layout, p_from_sub_tile_max=True), ref)
    assert not _passes(_launch(args, layout, drop_last_share=True), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("elem", ["int8", "float8_e4m3"])
@pytest.mark.parametrize("L, target", [(1024, 700), (256, 200), (8192, 5000), (1152, 900)],
                         ids=["L=1024", "L=256", "L=8192", "L=1152"])
def test_cuda_attention_row_invariance(cuda_device, elem, L, target):
    """A query row's bytes are the same computed alone (b = 1, sq = 1: the
    16-row layout), in a batch of 32 with other prefixes, and as the last
    position of a prefill of 64 over the same cache (64-row tiles to L =
    2048); and the same again on a second call."""
    b, hq, hkv, i = 32, 32, 8, 5
    cache = _cache(cuda_device, 8, b, hkv, L, elem)
    kv = [1 + (L - 1) * j // (b - 1) for j in range(b)]
    kv[i] = target
    batch_args = _args(cache, 9, hq, 1, kv, elem)
    batch = _launch(batch_args)
    one = MXLayerKVCache(*(t[i:i + 1] for t in cache.buffers), cache.elem_dtype_name, cache.block_size, "seq")
    args = (batch_args[0][i:i + 1], *one.buffers, batch_args[5][i:i + 1], batch_args[6][i:i + 1], *batch_args[7:])
    alone = _launch(args)
    pre = _args(one, 10, hq, 64, [target], elem)
    pre[0][:, :, -1] = args[0][0, :, 0]
    prefill = _launch(pre)
    assert _passes(alone, _plain(args))
    assert torch.equal(alone[0], batch[i])
    assert torch.equal(alone[0, :, 0], prefill[0, :, -1])
    assert torch.equal(_launch(args), alone)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64])
def test_cuda_attention_numeric_kv_len(cuda_device, sq):
    """Where q_off and kv_len are numbers the wrapper launches only the
    shares below kv_len: the same bytes as with (b,) tensors."""
    cache = _cache(cuda_device, 11, 3, 8, 1024, "int8")
    P = ca.attention_share(1024)
    for kv in (sq, P, P + 1, 700, 1024):
        args = _args(cache, 12, 32, sq, [kv] * 3, "int8")
        q_off = max(kv - sq, 0)
        assert torch.equal(_launch((*args[:5], q_off, kv, *args[7:])), _launch(args))
