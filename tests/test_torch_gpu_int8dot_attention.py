"""K7 (``csrc/mx_attention_int8dot.cu``, ``cuda_attention.mx_cached_attention_int8dot``)
on the card, against its plain version; imports neither JAX nor flax, so the
machine with the card can collect it.  Every case needs an NVIDIA GPU (marker
``gpu``) and skips elsewhere.  The tests directory's ``conftest.py`` imports
JAX, so on a machine without JAX run this file without it:

    python -m pytest tests/test_torch_gpu_int8dot_attention.py -m gpu -q --noconftest

Shapes: d = 128, GQA groups of 1 to 8 (3, 5, 6 and 7 in the kernel built
for 4 or 8 rows; 28 query heads over 4 KV heads is Qwen2-7B's), caches of 128 to 8192
positions (JAX's tile ``_pick_lt(L)``: 128 to 2048), visible prefixes at and
around the tile edges and a batch row that sees no key.  Tolerances: abs <=
2e-2 of the plain version (fp32 sums in another order, rare ties of the
requantized p; the model check's kernel tolerance) and each row's relative
L2 error <= ``chip_smoke.K7_ROW_REL`` (which a combine that drops a last tile
of one position fails); a row with no visible key exactly 0; a row's bytes
the same alone and in a batch of 32, from one call to the next (the combine's
tickets reset) and with a numeric kv_len (the grid cut to its tiles) as with
a tensor; q's codes and scales, quantized in the kernel's prologue, equal to
K1's bit for bit; the query heads read at the padded instance's stride (a
planted fault) fail the gate at every padded group, and so do p's codes
rounded down (a planted fault) at a group of 7.
"""

import pytest
import torch

from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_lib

ROW_REL = 1.2e-2  # chip_smoke.K7_ROW_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cache(device, seed, b, hkv, L, d=128):
    """Random K/V written into an int8 d-major cache through the port's own
    write path (K1, the store along the last axis)."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    v = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(device)
    cache = MXLayerKVCache.create(b, hkv, L, d, "int8", device=device, layout="dmajor")
    cache.write(k, v, 0)
    return cache, g


def _args(device, seed, b, hq, hkv, L, kv_len, d=128):
    """K7's arguments: row i's query at position kv_len[i] - 1."""
    cache, g = _cache(device, seed, b, hkv, L, d)
    q = torch.randn(b, hq, 1, d, generator=g).to(torch.bfloat16).to(device)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=device)
    return (q, *cache.buffers, (kv - 1).clamp(min=0), kv, d ** -0.5)


def _launch(args, **kw):
    """K7 on args, asserting that the call launches the kernel once (and no K1)."""
    before = dict(cuda_lib.LAUNCHES)
    out = ca.mx_cached_attention_int8dot(*args, **kw)
    after = dict(cuda_lib.LAUNCHES)
    assert after.get("mx_cached_attention_int8dot", 0) == before.get("mx_cached_attention_int8dot", 0) + 1
    assert after.get("mx_quantize", 0) == before.get("mx_quantize", 0)
    return out


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _row_rel(a, b):
    """The worst row's relative L2 error (a row of b that is all 0 must match exactly)."""
    num = (a.double() - b.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / b.double().norm(dim=-1)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,L", [(32, 8, 1024), (4, 2, 256), (8, 1, 8192), (2, 2, 128)])
def test_cuda_int8dot_kernel_matches_plain(cuda_device, hq, hkv, L):
    b, d = 5, 128
    cache, g = _cache(cuda_device, 5, b, hkv, L, d)
    q = torch.randn(b, hq, 1, d, generator=g).to(torch.bfloat16).to(cuda_device)
    q_off = torch.tensor([0, 0, L // 2, L - 1, L], dtype=torch.int32, device=cuda_device)
    kv_len = torch.tensor([0, 1, L // 3, L, L + 1], dtype=torch.int32, device=cuda_device)
    args = (q, *cache.buffers, q_off, kv_len, d ** -0.5)
    out = ca.mx_cached_attention_int8dot(*args)
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    assert out[0].abs().max().item() == 0
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(out, ca.mx_cached_attention_int8dot(*args))  # deterministic


def _edges(L):
    lt = ca._pick_lt(L)
    return [kv for kv in (0, 1, lt - 1, lt, lt + 1, 2 * lt - 1, 2 * lt + 1, L) if kv <= L]


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("L", [256, 1024, 8192])
def test_k7_matches_plain_at_tile_edges(cuda_device, G, L):
    """Every GQA group the kernel takes, visible prefixes at and around the
    tile edges; a row with no key gives exactly 0."""
    kv = _edges(L)
    args = _args(cuda_device, 11, len(kv), 2 * G, 2, L, kv)
    out = _launch(args)
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    assert torch.isfinite(out.float()).all()
    assert _err(out, ref) <= 2e-2 and _row_rel(out, ref) <= ROW_REL, (_err(out, ref), _row_rel(out, ref))
    assert out[kv.index(0)].abs().max().item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1024, 8192])
def test_k7_row_alone_equals_row_in_a_batch(cuda_device, L):
    """A row's bytes depend on its own q_off, kv_len and L only: alone, in a
    batch of 32 and with a numeric kv_len (the grid cut to its tiles)."""
    lt = ca._pick_lt(L)
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
def test_k7_repeat_calls_give_the_same_bytes(cuda_device):
    """The combine's tickets reset: a second and third call give the same bytes."""
    kv = [0, 300, 513, 1024, 700, 1025]
    args = _args(cuda_device, 13, len(kv), 32, 8, 1024, kv)
    first = _launch(args)
    assert torch.equal(_launch(args), first) and torch.equal(_launch(args), first)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_k7_prologue_quantizes_q_as_k1(cuda_device, G):
    """The codes and scales of q that the kernel computes in its prologue are
    K1's (``quantize_q_int8`` on the card), bit for bit; q_out is null on
    the served path."""
    b, hkv = 3, 2
    args = _args(cuda_device, 14, b, G * hkv, hkv, 1024, [700, 1, 1024])
    # bf16 values of every magnitude, zeros and subnormals among them
    q = args[0]
    q.view(-1)[::7] = 0
    q.view(-1)[1::11] *= 2.0 ** -120
    q.view(-1)[2::13] *= 2.0 ** 100
    want_s, want_c = ca.quantize_q_int8(q, hkv)
    got_s, got_c = torch.empty_like(want_s), torch.empty_like(want_c)
    out = _launch(args, q_out=(got_s, got_c))
    assert torch.equal(got_s, want_s) and torch.equal(got_c, want_c)
    assert torch.equal(out, _launch(args))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["lt+1", "2lt+1"])
@pytest.mark.parametrize("L", [1024, 8192])
def test_k7_gate_catches_dropped_tile(cuda_device, L, kv):
    """The planted combine fault (the last live tile left out) at a last tile
    of one position, one batch row alone: the kernel passes the row gate, the
    fault fails it."""
    lt = ca._pick_lt(L)
    n = {"lt+1": lt + 1, "2lt+1": 2 * lt + 1}[kv]
    args = _args(cuda_device, 15, 1, 32, 8, L, [n])
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    assert _row_rel(_launch(args), ref) <= ROW_REL
    assert _row_rel(_launch(args, drop_last_tile=True), ref) > ROW_REL


@pytest.mark.gpu
def test_k7_gate_catches_q_scale_of_the_next_chunk(cuda_device):
    """The planted prologue fault (q's scale of chunk c taken from chunk c +
    1) fails the gate."""
    args = _args(cuda_device, 16, 4, 32, 8, 1024, [1, 300, 700, 1024])
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    bad = _launch(args, q_scale_from_next_chunk=True)
    assert _err(bad, ref) > 2e-2 or _row_rel(bad, ref) > ROW_REL


@pytest.mark.gpu
@pytest.mark.parametrize("G", [3, 5, 6, 7])
@pytest.mark.parametrize("L", [1024, 8192])
def test_k7_padded_group_and_its_stride_fault(cuda_device, G, L):
    """A group of 3, 5, 6 or 7 (4 KV heads, Qwen2-7B's at 7) over a ragged
    batch: the kernel passes the gate, one launch (the workspace sized by the
    true hq); its query heads read at the stride of the instance it runs in
    (a planted fault) fail it."""
    kv = [0] + [1 + (i * (L - 1)) // 6 for i in range(7)]
    args = _args(cuda_device, 18, len(kv), 4 * G, 4, L, kv)
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    out = _launch(args)
    assert _err(out, ref) <= 2e-2 and _row_rel(out, ref) <= ROW_REL, (_err(out, ref), _row_rel(out, ref))
    assert out[0].abs().max().item() == 0
    bad = _launch(args, pad_stride=True)
    assert _err(bad, ref) > 2e-2 or _row_rel(bad, ref) > ROW_REL


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1024, 8192])
def test_k7_gate_catches_p_codes_rounded_down(cuda_device, L):
    """The planted rounding fault (p's int8 codes rounded down, not to
    nearest) at a group of 7 over a ragged batch fails the gate."""
    kv = [1 + (i * (L - 1)) // 7 for i in range(8)]
    args = _args(cuda_device, 19, len(kv), 28, 4, L, kv)
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    bad = _launch(args, p_codes_down=True)
    assert _err(bad, ref) > 2e-2 or _row_rel(bad, ref) > ROW_REL
