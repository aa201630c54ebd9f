"""B12 (``csrc/mx_grouped_matmul.cu``) on the card, against its plain
version and against B6; imports neither JAX nor flax, so the machine with
the card can collect it.  Every case needs an NVIDIA GPU (marker ``gpu``)
and skips elsewhere.  The tests directory's ``conftest.py`` imports JAX, so
on a machine without JAX run this file without it:

    python -m pytest tests/test_torch_gpu_grouped.py -m gpu -q --noconftest

Shapes: Mixtral-8x7B's w1/w3 and w2 (E = 8, top-2) and Moonlight-16B-A3B's
routed w1/w3 and w2 (E = 64, top-6), at T = 1, 32 (decode), 40 (wgmma n64),
512 (an admission) and 2048 (prefill) tokens, row tiles of 8 and 128, every
expert format, each expert's rows bounded by T as the MoE block bounds them.
Tolerances: rel <= 1e-2 (max abs difference over max abs) of the plain
version (fp32 sums in another order); every live tile bit for bit equal to
B6 on the same rows and expert (the same partials added in the same order);
every dead or padding row exactly 0; a token's rows the same bytes at every
token count (the wgmma n, the walk and the two-pass form change with it).
"""

import functools

import pytest
import torch

from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
from torchmx_tpu_torch.ops import cuda_moe, moe

SHAPES = {"mixtral w1": (8, 2, 4096, 14336), "mixtral w2": (8, 2, 14336, 4096),
          "moonlight w1": (64, 6, 2048, 1408), "moonlight w2": (64, 6, 1408, 2048)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=4)
def _weights(shape, elem):
    """Stacked (E, K, N) experts of ``elem`` itself (``quantize_stacked``
    re-codes e2m3 as int8) and their scales, from a seed; bf16 for None."""
    E, _, K, N = SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(K + N)
    w = (torch.randn(E, K, N, generator=g, device="cuda") * K ** -0.5).to(torch.bfloat16)
    if elem is None:
        return w, None
    ts = [MXTensor.to_mx(w[e].t().contiguous(), elem) for e in range(E)]
    return (torch.stack([t.data.t() for t in ts]).contiguous(),
            torch.stack([t.scale_e8m0.t() for t in ts]).contiguous())


def _layout(T, E, k, K, tm, seed):
    """x sorted by expert for T tokens routed to k distinct experts each."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, K, generator=g, device="cuda").to(torch.bfloat16)
    top = torch.rand(T, E, generator=g, device="cuda").argsort(dim=1)[:, :k].to(torch.int32)
    return moe.group_tokens(x, top, tm, E)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 32, 40, 512, 2048])
@pytest.mark.parametrize("tm", [8, 128])
@pytest.mark.parametrize("elem", cuda_moe.GROUPED_FORMATS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_grouped_kernel_matches_plain_and_b6(cuda_device, shape, elem, tm, T):
    E, k, K, _ = SHAPES[shape]
    codes, scales = _weights(shape, elem)
    xs, te, tr, _ = _layout(T, E, k, K, tm, T + tm)
    bounds = moe.row_bounds(T, k, E)
    out = cuda_moe.mx_grouped_matmul(xs, codes, te, tr, tm, scales, elem, **bounds)
    ref = cuda_moe.mx_grouped_matmul_plain(xs, codes, te, tr, tm, scales, elem, **bounds)
    assert _rel(out, ref) <= 1e-2
    ext = min(T, tm)
    live = torch.arange(xs.shape[0], device=cuda_device) % tm < tr.clamp(max=ext).repeat_interleave(tm)
    assert torch.equal(out[~live].view(torch.int16), torch.zeros_like(out[~live]).view(torch.int16))
    if elem is not None:  # the same expert and rows through B6: the same bytes
        for t, (e, n) in enumerate(zip(te.tolist(), tr.tolist())):
            n = min(n, ext)
            if n:
                rows = slice(t * tm, t * tm + n)
                assert torch.equal(out[rows], kf.mx_matmul_1byte(xs[rows].contiguous(), codes[e], scales[e], elem))


@pytest.mark.gpu
@pytest.mark.parametrize("elem", [None, "int8", "float6_e3m2"])
@pytest.mark.parametrize("shape", ["mixtral w2", "moonlight w1"])
def test_cuda_grouped_kernel_is_row_invariant(cuda_device, shape, elem):
    """Each token's rows keep their bytes from 1 to 300 tokens: the wgmma n
    (16 to 128), the walk and the two-pass form (Mixtral's w2 at one token)
    change with the count."""
    E, k, K, _ = SHAPES[shape]
    codes, scales = _weights(shape, elem)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(300, K, generator=g, device="cuda").to(torch.bfloat16)
    top = torch.rand(300, E, generator=g, device="cuda").argsort(dim=1)[:, :k].to(torch.int32)

    def rows_of(T):
        xs, te, tr, dest = moe.group_tokens(x[:T], top[:T], 128, E)
        out = cuda_moe.mx_grouped_matmul(xs, codes, te, tr, 128, scales, elem, **moe.row_bounds(T, k, E))
        return out[dest.long()]

    full = rows_of(300)
    for T in (1, 2, 15, 16, 17, 33, 64, 65, 129, 299):
        assert torch.equal(rows_of(T).view(torch.int16), full[:T * k].view(torch.int16)), T


@pytest.mark.gpu
def test_cuda_grouped_kernel_planted_faults_change_the_result(cuda_device):
    """Each planted fault moves the output (the model check relies on it):
    every token on experts 0 and 1, so that their tiles hold the bound's 32
    rows and the last one is a token's."""
    E, k, K, _ = SHAPES["mixtral w2"]
    codes, scales = _weights("mixtral w2", "int8")
    x = torch.randn(32, K, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda").to(torch.bfloat16)
    top = torch.arange(k, dtype=torch.int32, device="cuda").expand(32, k).contiguous()
    xs, te, tr, _ = moe.group_tokens(x, top, 128, E)
    bounds = moe.row_bounds(32, k, E)
    out = cuda_moe.mx_grouped_matmul(xs, codes, te, tr, 128, scales, "int8", **bounds)
    for fault in cuda_moe.B12_FAULTS.values():
        bad = cuda_moe.mx_grouped_matmul(xs, codes, te, tr, 128, scales, "int8", fault=fault, **bounds)
        assert not torch.equal(bad, out)
