"""B9 (``csrc/mx_matmul_int8dot.cu``) and K1's dot-order mode on the card,
against their plain versions; imports neither JAX nor flax, so the machine
with the card can collect it.  Every case needs an NVIDIA GPU (marker
``gpu``) and skips elsewhere.  The tests directory's ``conftest.py`` imports
JAX, so on a machine without JAX run this file without it:

    python -m pytest tests/test_torch_gpu_int8dot.py -m gpu -q --noconftest

Tolerances: K1's dot-order mode bit for bit over every bf16 pattern; int8
B9 within one bf16 step of its plain version (exact block sums; the split
order differs from the plain version's single pass) and bit for bit equal
to B6 with int8 ``act_fq`` (the same exact partials in the same order);
e4m3 B9 within rel 1e-2 (max abs difference over max abs) and L2 rel
1.5e-4 of its plain version, whose block sums are exact (the kernel's are
f32 sums of exact products, in another order; ``chip_smoke.py``'s
``B9_FP8_L2_REL_MAX`` says why that limit); both give a row the same bytes
at every row count, and a two-pass plan the same bytes with its reduce
launched by the kernel's call or by its own.
"""

import pytest
import torch

from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
from torchmx_tpu_torch.ops import cuda_quantize as cq


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _within_one_bf16_step(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126))) - 7)
    return bool(((a - b).abs() <= ulp).all())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _l2_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _weight(dev, K, N, fmt, seed):
    g = torch.Generator().manual_seed(seed)
    return MXTensor.to_mx((torch.randn(N, K, generator=g) * K ** -0.5).to(torch.bfloat16).to(dev), fmt).T


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", cq.DOT_FORMATS)
def test_cuda_dot_order_quantize_is_plain_on_every_bf16_pattern(cuda_device, fmt):
    b = torch.arange(65536, dtype=torch.int32)
    x = torch.where(b >= 32768, b - 65536, b).to(torch.int16).view(torch.bfloat16).reshape(128, 512).to(cuda_device)
    for rows in (x, x[:17].contiguous(), x[:1].contiguous()):
        s, c = cq.mx_quantize_dot(rows, fmt)
        sp, cp = cq.mx_quantize_dot_plain(rows, fmt)
        assert torch.equal(s.view(torch.int32), sp.view(torch.int32))
        assert torch.equal(c.view(torch.uint8), cp.view(torch.uint8))


# (K, N) of Llama-3-8B's q/o, k/v, gate/up and down projections.
SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 17, 32, 65, 256])
@pytest.mark.parametrize("K,N", SHAPES)
def test_cuda_int8dot_matches_plain_and_b6(cuda_device, K, N, M):
    w = _weight(cuda_device, K, N, "int8", 5)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16).to(cuda_device)
    out = kf.mx_matmul_int8dot(x, w.data, w.scale_e8m0)
    sx, xc = cq.mx_quantize(x, "int8")
    assert _within_one_bf16_step(out, kf.mx_matmul_int8dot_plain(xc, sx, w.data, w.scale_e8m0))
    assert torch.equal(out, kf.mx_matmul_1byte(x, w.data, w.scale_e8m0, "int8", "int8"))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 17, 32, 65, 256])
@pytest.mark.parametrize("K,N", SHAPES)
def test_cuda_fp8dot_matches_plain(cuda_device, K, N, M):
    w = _weight(cuda_device, K, N, "float8_e4m3", 7)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(8)).to(torch.bfloat16).to(cuda_device)
    out = kf.mx_matmul_int8dot(x, w.data, w.scale_e8m0, True)
    sx, xc = cq.mx_quantize(x, "float8_e4m3")
    plain = kf.mx_matmul_int8dot_plain(xc, sx, w.data, w.scale_e8m0, True)
    assert _rel(out, plain) <= 1e-2
    assert _l2_rel(out, plain) <= 1.5e-4


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [False, True])
def test_cuda_int8dot_is_row_invariant(cuda_device, fp8):
    fmt = "float8_e4m3" if fp8 else "int8"
    w = _weight(cuda_device, 4096, 4096, fmt, 9)
    x = torch.randn(256, 4096, generator=torch.Generator().manual_seed(10)).to(torch.bfloat16).to(cuda_device)
    full = kf.mx_matmul_int8dot(x, w.data, w.scale_e8m0, fp8)
    for k in (1, 2, 15, 16, 17, 64, 65, 128, 129, 255):
        assert torch.equal(kf.mx_matmul_int8dot(x[:k].contiguous(), w.data, w.scale_e8m0, fp8), full[:k])


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (14336, 4096)])
def test_cuda_int8dot_reduce_in_the_kernels_call(cuda_device, K, N, fp8):
    """At the shapes whose plan has a second pass, the served call (the
    reduce launched by the kernel's own call) gives the bytes of the kernel
    alone followed by ``b9_reduce``."""
    fmt = "float8_e4m3" if fp8 else "int8"
    w = _weight(cuda_device, K, N, fmt, 11)
    x = torch.randn(32, K, generator=torch.Generator().manual_seed(12)).to(torch.bfloat16).to(cuda_device)
    plan = kf.plan_int8dot(32, N, K, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert plan.splits > 1 and not plan.walk
    px_t, xd = cq.mx_quantize_dot(x, fmt)
    out, ws = kf.b9_kernel(xd, px_t, w.data, w.scale_e8m0, fp8, plan)
    assert torch.equal(kf.mx_matmul_int8dot(x, w.data, w.scale_e8m0, fp8), kf.b9_reduce(ws, out, fp8))
