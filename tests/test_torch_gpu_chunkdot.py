"""K5 (``csrc/mx_attention_chunkdot.cu``, ``cuda_attention.mx_cached_attention_chunkdot``)
on the card, against its plain version; imports neither JAX nor flax, so the
machine with the card can collect it.  Every case needs an NVIDIA GPU (marker
``gpu``) and skips elsewhere.  The tests directory's ``conftest.py`` imports
JAX, so on a machine without JAX run this file without it:

    python -m pytest tests/test_torch_gpu_chunkdot.py -m gpu -q --noconftest

Shapes: d = 128, GQA groups of 1 to 8 (3, 5, 6 and 7 in the kernel built
for 4 or 8 rows; 28 query heads over 4 KV heads is Qwen2-7B's), caches of 64 to 8192
positions (JAX's tile ``_pick_lt(L)``: 128 to 2048; the whole cache where
none divides L; at L = 1152 and 2304 nine tiles, so that a CTA takes
several), visible prefixes at and around the tile and share edges and a
batch row that sees no key.  Tolerances: abs <= 2e-2 of the plain version
(the model check's kernel tolerance), each row's relative L2 error <=
``chip_smoke.K5_ROW_REL`` (which a dropped last tile fails) and the whole
output's <= ``chip_smoke.K5_L2_REL`` (which p rounded against its tile's own
maximum fails): the kernel rounds every p against the plain version's
running maximum and differs in fp32 summation order only; a row with no
visible key exactly 0; a stale 255 scale past the prefix changes nothing; a
row's bytes the same alone and in a batch of 32, from one call to the next
and with a numeric kv_len (the grid cut to its tiles) as with a tensor; one
launch a call; the query heads read at the padded instance's stride (a
planted fault) fail the gate at every padded group.
"""

import pytest
import torch

from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_lib, cuda_quantize

ROW_REL, L2_REL = 8e-3, 5e-4  # chip_smoke.K5_ROW_REL, K5_L2_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _args(device, seed, b, hq, hkv, L, kv_len, d=128):
    """K5's arguments over random K/V written into an int8 seq cache through
    the port's own write path (K1, the store by position): row i's query at
    position kv_len[i] - 1, nothing written past its prefix."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    v = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    cache = MXLayerKVCache.create(b, hkv, L, d, "int8", device=device)
    cache.write(k, v, 0)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=device)
    fresh = (torch.arange(L, device=device) >= kv[:, None])[:, None, :, None]
    buffers = [t.masked_fill(fresh, 0) for t in cache.buffers]
    q = torch.randn(b, hq, 1, d, generator=g).to(torch.bfloat16).to(device)
    return (q, *buffers, (kv - 1).clamp(min=0), kv, d ** -0.5)


def _launch(args, **kw):
    """K5 on args, asserting that the call launches the kernel once."""
    before = dict(cuda_lib.LAUNCHES)
    out = ca.mx_cached_attention_chunkdot(*args, **kw)
    after = dict(cuda_lib.LAUNCHES)
    assert after.get("mx_cached_attention_chunkdot", 0) == before.get("mx_cached_attention_chunkdot", 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return out


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _row_rel(a, b):
    """The worst row's relative L2 error (a row of b that is all 0 must match exactly)."""
    num = (a.double() - b.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / b.double().norm(dim=-1)).max().item()


def _passes(a, b):
    """K5's gate: abs, the worst row's and the whole output's relative L2 error."""
    return (_err(a, b) <= 2e-2 and _row_rel(a, b) <= ROW_REL
            and ((a.double() - b.double()).norm() / b.double().norm()).item() <= L2_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,L", [(32, 8, 1024), (4, 2, 256), (8, 1, 8192), (2, 2, 64)])
def test_cuda_chunkdot_kernel_matches_plain(cuda_device, hq, hkv, L):
    b, d = 5, 128
    g = torch.Generator().manual_seed(3)
    k = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(cuda_device)
    v = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(cuda_device)
    ks, kd = cuda_quantize.mx_quantize(k, "int8")
    vs, vd = cuda_quantize.mx_quantize(v, "int8")
    q = torch.randn(b, hq, 1, d, generator=g).to(torch.bfloat16).to(cuda_device)
    q_off = torch.tensor([0, 0, L // 2, L - 1, L], dtype=torch.int32, device=cuda_device)
    kv_len = torch.tensor([0, 1, L // 3, L, L + 1], dtype=torch.int32, device=cuda_device)
    args = (q, kd, ks, vd, vs, q_off, kv_len, d ** -0.5)
    out = ca.mx_cached_attention_chunkdot(*args)
    ref = ca.mx_cached_attention_chunkdot_plain(*args)
    assert out[0].abs().max().item() == 0
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(out, ca.mx_cached_attention_chunkdot(*args))  # deterministic


def _edges(L):
    lt, P = ca.attention_tile(L), ca.k5_share(L)
    return sorted({kv for kv in (0, 1, lt - 1, lt, lt + 1, 2 * lt - 1, 2 * lt + 1, P - 1, P, P + 1, 2 * P + 1, L)
                   if 0 <= kv <= L})


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("L", [256, 1024, 1152, 2304, 8192])
def test_k5_matches_plain_at_tile_edges(cuda_device, G, L):
    """Every GQA group the kernel takes, visible prefixes at and around the
    tile and share edges (at L = 1152 and 2304 a share holds four and two tiles); a
    row with no key gives exactly 0."""
    kv = _edges(L)
    args = _args(cuda_device, 11, len(kv), 2 * G, 2, L, kv)
    out = _launch(args)
    ref = ca.mx_cached_attention_chunkdot_plain(*args)
    assert torch.isfinite(out.float()).all()
    assert _passes(out, ref), (_err(out, ref), _row_rel(out, ref))
    assert out[kv.index(0)].abs().max().item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("L", [256, 1024])
def test_k5_stale_scale_past_the_prefix_changes_nothing(cuda_device, L):
    """Codes and scales past a row's prefix (255 scales: +inf, a stale slot)
    are never multiplied: the row's bytes stay those of a fresh cache."""
    kv = [1, 100, ca.attention_tile(L) + 3]
    args = _args(cuda_device, 17, len(kv), 8, 2, L, kv)
    clean = _launch(args)
    stale = [t.clone() for t in args[1:5]]
    for i, n in enumerate(kv):
        for t in stale:
            t[i, :, n:] = 0x7F if t.dtype == torch.int8 else 255
    assert torch.equal(_launch((args[0], *stale, *args[5:])), clean)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1024, 1152, 8192])
def test_k5_row_alone_equals_row_in_a_batch(cuda_device, L):
    """A row's bytes depend on its own q_off, kv_len and L only: alone, in a
    batch of 32 and with a numeric kv_len (the grid cut to its tiles)."""
    lt = ca.attention_tile(L)
    kv = [1 + (i * (L - 1)) // 31 for i in range(32)]
    kv[5] = lt + 1
    args = _args(cuda_device, 12, 32, 32, 8, L, kv)
    whole = _launch(args)
    for i in (0, 5, 17, 31):
        one = (args[0][i:i + 1], *(t[i:i + 1].contiguous() for t in args[1:7]), args[7])
        assert torch.equal(_launch(one), whole[i:i + 1])
        numbers = (*one[:5], kv[i] - 1, kv[i], one[7])
        assert torch.equal(_launch(numbers), whole[i:i + 1])


@pytest.mark.gpu
def test_k5_repeat_calls_give_the_same_bytes(cuda_device):
    kv = [0, 300, 513, 1024, 700, 1025]
    args = _args(cuda_device, 13, len(kv), 32, 8, 1024, kv)
    first = _launch(args)
    assert torch.equal(_launch(args), first) and torch.equal(_launch(args), first)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["lt+1", "2lt+1"])
@pytest.mark.parametrize("L", [1024, 1152, 8192])
def test_k5_gate_catches_dropped_tile(cuda_device, L, kv):
    """The planted fault (the last live tile left out) at a last tile of one
    position, one batch row alone (at L = 1152 the tile lies in a share of
    four): the kernel passes the gate, the fault fails the row gate."""
    lt = ca.attention_tile(L)
    n = {"lt+1": lt + 1, "2lt+1": 2 * lt + 1}[kv]
    args = _args(cuda_device, 15, 1, 32, 8, L, [n])
    ref = ca.mx_cached_attention_chunkdot_plain(*args)
    assert _passes(_launch(args), ref)
    bad = _launch(args, drop_last_tile=True)
    assert _err(bad, ref) > 2e-2 or _row_rel(bad, ref) > ROW_REL


@pytest.mark.gpu
@pytest.mark.parametrize("L,kv", [(1024, "2lt"), (1152, "2lt"), (1152, "L"), (8192, "2lt"), (8192, "L")])
def test_k5_gate_catches_p_against_its_own_tile_max(cuda_device, L, kv):
    """The planted rounding fault (p of each tile rounded against the tile's
    own maximum, not JAX's running one: the same function in exact
    arithmetic, other bf16 roundings) over two and more whole tiles, one
    batch row alone: the kernel passes the gate, the fault fails it."""
    lt = ca.attention_tile(L)
    n = {"2lt": 2 * lt, "L": L}[kv]
    args = _args(cuda_device, 16, 1, 32, 8, L, [n])
    ref = ca.mx_cached_attention_chunkdot_plain(*args)
    assert _passes(_launch(args), ref)
    assert not _passes(_launch(args, p_from_own_tile_max=True), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [3, 5, 6, 7])
@pytest.mark.parametrize("L", [1024, 8192])
def test_k5_padded_group_and_its_stride_fault(cuda_device, G, L):
    """A group of 3, 5, 6 or 7 (4 KV heads, Qwen2-7B's at 7) over a ragged
    batch: the kernel passes the gate, one launch; its query heads read at
    the stride of the instance it runs in (a planted fault) fail it."""
    kv = [0] + [1 + (i * (L - 1)) // 6 for i in range(7)]
    args = _args(cuda_device, 18, len(kv), 4 * G, 4, L, kv)
    ref = ca.mx_cached_attention_chunkdot_plain(*args)
    out = _launch(args)
    assert _passes(out, ref), (_err(out, ref), _row_rel(out, ref))
    assert out[0].abs().max().item() == 0
    assert not _passes(_launch(args, pad_stride=True), ref)
