"""B12's host side on the CPU: the row bounds the MoE block passes, the
plain version under those bounds, the launch plan (wgmma n, walk or two
passes, the workspace) and what the wrapper
hands the kernel or refuses.  The kernel itself runs only on a card
(``tests/test_torch_gpu_grouped.py``).

Tolerances: the plain version under a true bound equals the unbounded one
bit for bit (the rows the bound drops are the zero padding of
``group_tokens``); everything else here is exact integer logic.
"""

import pytest
import torch

from torchmx_tpu_torch.models import mixtral as tmix
from torchmx_tpu_torch.ops import cuda_lib, cuda_moe, moe
from torchmx_tpu_torch.ops.cuda_matmul import k_splits

torch.set_num_threads(1)

SMS = 132  # an H100 SXM
# (E, k, K, N) of the served MoE linears: Mixtral-8x7B w1/w3 and w2, Moonlight-16B-A3B's routed w1/w3 and w2.
SHAPES = {"mixtral w1": (8, 2, 4096, 14336), "mixtral w2": (8, 2, 14336, 4096),
          "moonlight w1": (64, 6, 2048, 1408), "moonlight w2": (64, 6, 1408, 2048)}


def _routing(T, E, k, seed):
    """(T, k) int32 distinct experts per token, as top-k routing gives them."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(T, E, generator=g).argsort(dim=1)[:, :k].to(torch.int32)


@pytest.mark.parametrize("T,k,E", [(1, 2, 8), (3, 2, 8), (32, 2, 8), (1, 6, 64), (32, 6, 64), (4, 3, 4)])
def test_row_bounds_hold_for_every_expert(T, k, E):
    """No expert of a top-k layout holds more than ``max_rows`` rows, and no
    more than ``max_experts`` experts hold any."""
    b = moe.row_bounds(T, k, E)
    assert b == dict(max_rows=T, max_experts=min(E, T * k))
    counts = torch.bincount(_routing(T, E, k, T + E).reshape(-1).long(), minlength=E)
    assert int(counts.max()) <= b["max_rows"] and int((counts > 0).sum()) <= b["max_experts"]


def test_moe_block_passes_its_token_count_to_every_grouped_matmul(monkeypatch):
    """The grouped block calls B12 three times a forward, each with the
    row bounds of its T = b * s tokens and top-k."""
    cfg = tmix.MixtralConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                             num_attention_heads=2, num_key_value_heads=1, head_dim=32,
                             num_local_experts=4, num_experts_per_tok=2)
    blk = tmix.MixtralSparseMoeBlock(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    blk.grouped, blk.grouped_tm = True, 8
    seen, orig = [], moe.grouped_matmul

    def record(*args, **kwargs):
        seen.append((kwargs.get("max_rows"), kwargs.get("max_experts")))
        return orig(*args, **kwargs)

    monkeypatch.setattr(moe, "grouped_matmul", record)
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    y = blk(x)
    assert seen == [(15, 4)] * 3
    monkeypatch.setattr(moe, "row_bounds", lambda T, k, E: {})  # no bound: every row of a tile multiplied
    assert torch.equal(y.view(torch.int16), blk(x).view(torch.int16))


@pytest.mark.parametrize("elem", [None, "int8", "float8_e4m3"])
@pytest.mark.parametrize("tm", [8, 16])
def test_plain_under_the_row_bound_is_the_unbounded_result(elem, tm):
    """Under a true bound the plain B12 drops only zero padding rows; under
    a smaller one, a tile's rows past it come out as 0."""
    g = torch.Generator().manual_seed(3)
    E, k, K, N, T = 4, 2, 64, 64, 11
    x = torch.randn(T, K, generator=g).to(torch.bfloat16)
    if elem is None:
        w, s = (torch.randn(E, K, N, generator=g) * 0.1).to(torch.bfloat16), None
    else:
        from torchmx_tpu_torch.mx_array import quantize_stacked

        w, s = quantize_stacked((torch.randn(E, K, N, generator=g) * 0.1).to(torch.bfloat16), elem)
    xs, te, tr, _ = moe.group_tokens(x, _routing(T, E, k, 5), tm, E)
    full = cuda_moe.mx_grouped_matmul_plain(xs, w, te, tr, tm, s, elem)
    bounded = cuda_moe.mx_grouped_matmul(xs, w, te, tr, tm, s, elem, **moe.row_bounds(T, k, E))
    assert torch.equal(bounded.view(torch.int16), full.view(torch.int16))
    short = cuda_moe.mx_grouped_matmul_plain(xs, w, te, tr, tm, s, elem, max_rows=3)
    keep = (torch.arange(xs.shape[0]) % tm < 3)[:, None]
    assert torch.equal(short.view(torch.int16), torch.where(keep, full, 0).view(torch.int16))
    with pytest.raises(ValueError, match="max_rows"):
        cuda_moe.mx_grouped_matmul_plain(xs, w, te, tr, tm, s, elem, max_rows=0)


# (shape, T) -> (nb, walk) on a 132-SM card at tm = 128: decode b=1 and b=32, an admission, prefill.
PLANS = {("mixtral w1", 1): (16, True), ("mixtral w1", 32): (32, True), ("mixtral w1", 512): (128, True),
         ("mixtral w1", 2048): (128, True), ("mixtral w2", 1): (16, False), ("mixtral w2", 32): (32, True),
         ("mixtral w2", 2048): (128, True), ("moonlight w1", 1): (16, True), ("moonlight w1", 32): (32, True),
         ("moonlight w2", 1): (16, True), ("moonlight w2", 32): (32, True), ("moonlight w2", 2048): (128, True)}


@pytest.mark.parametrize("shape,T", list(PLANS))
def test_plan_at_the_served_shapes(shape, T):
    """The wgmma n covers the tokens, the splits are B6's, and one launch
    (the walk) wherever the live row blocks fill half the card; the
    two-pass workspace is nb rows a row block, not (splits, R, N)."""
    E, k, K, N = SHAPES[shape]
    tm = 128
    R = moe.plan_group_layout(T, k, E, tm)
    plan = cuda_moe.plan_grouped(R, N, K, tm, SMS, **moe.row_bounds(T, k, E))
    assert (plan.nb, plan.walk) == PLANS[shape, T]
    assert plan.splits == k_splits(N, K, SMS) and plan.sb == 128 and plan.ext == min(T, tm)
    if plan.walk:
        assert plan.ws_shape == ()
    else:
        assert plan.ws_shape == (plan.splits, R // 128, plan.nb, N)
        assert plan.splits * (R // 128) * plan.nb < plan.splits * R


@pytest.mark.parametrize("tm", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("max_rows", [None, 1, 7, 16, 17, 33, 64, 65, 300])
def test_plan_nb_covers_every_live_row(tm, max_rows):
    plan = cuda_moe.plan_grouped(4 * tm, 256, 512, tm, SMS, max_rows, 4)
    live = min(tm if max_rows is None else max_rows, tm, 128)
    assert plan.sb == min(tm, 128) and plan.nb in cuda_moe.B12_NB
    assert plan.nb >= live and (plan.nb == 16 or plan.nb // 2 < live)


@pytest.fixture
def launch_on_cpu(monkeypatch):
    """The wrapper as on a card: ``on_cuda`` true, 132 SMs, and the launch
    recorded instead of made."""
    calls = []
    monkeypatch.setattr(cuda_moe, "on_cuda", lambda *a: True)
    monkeypatch.setattr(cuda_moe, "sm_count", lambda device: SMS)
    monkeypatch.setattr(cuda_lib, "launch", lambda src, fn, *args, **kw: calls.append((src, fn, args)))
    return calls


def _operands(E=8, K=128, N=256, T=3, k=2, tm=128, elem="int8"):
    x = torch.zeros(T, K, dtype=torch.bfloat16)
    xs, te, tr, _ = moe.group_tokens(x, _routing(T, E, k, 0), tm, E)
    w = torch.zeros(E, K, N, dtype=torch.int8 if elem == "int8" else torch.uint8)
    return xs, w, te, tr, torch.zeros(E, K // 32, N, dtype=torch.uint8)


def test_wrapper_hands_the_kernel_its_plan(launch_on_cpu):
    xs, w, te, tr, s = _operands()
    cuda_moe.mx_grouped_matmul(xs, w, te, tr, 128, s, "int8", **moe.row_bounds(3, 2, 8))
    cuda_moe.mx_grouped_matmul(xs, w, te, tr, 128, s, "int8", fault=cuda_moe.B12_FAULTS["extent one row short"])
    (src, fn, a), (_, _, b) = launch_on_cpu
    assert (src, fn) == ("mx_grouped_matmul", "mx_grouped_matmul_launch")
    R, N, K, E = xs.shape[0], 256, 128, 8
    plan = cuda_moe.plan_grouped(R, N, K, 128, SMS, 3, 6)
    # ..., R, N, K, E, tm, elem, ext, nb, splits, walk, fault
    assert a[7:] == (R, N, K, E, 128, cuda_lib.ELEM_CODES["int8"], 3, 16, plan.splits, int(plan.walk), 0)
    assert b[13:15] == (128, 128) and b[-1] == 2
    assert (a[6] == 0) == plan.walk  # the workspace pointer: none when the CTAs walk their splits


def test_wrapper_refuses_what_the_kernel_does_not_take(launch_on_cpu):
    xs, w, te, tr, s = _operands()
    with pytest.raises(ValueError, match="fault"):
        cuda_moe.mx_grouped_matmul(xs, w, te, tr, 128, s, "int8", fault=3)
    with pytest.raises(ValueError, match="max_rows"):
        cuda_moe.mx_grouped_matmul(xs, w, te, tr, 128, s, "int8", max_rows=0)
    xs8, w8, te8, tr8, s8 = _operands(tm=12)
    with pytest.raises(ValueError, match="tm a multiple of 8"):
        cuda_moe.mx_grouped_matmul(xs8, w8, te8, tr8, 12, s8, "int8")
    xk, wk, tek, trk, sk = _operands(K=96)
    with pytest.raises(ValueError, match="K % 64"):
        cuda_moe.mx_grouped_matmul(xk, wk, tek, trk, 128, sk, "int8")
    base = torch.zeros(xs.numel() + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(xs.shape)  # contiguous, 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_moe.mx_grouped_matmul(shifted, w, te, tr, 128, s, "int8")
    assert launch_on_cpu == []
