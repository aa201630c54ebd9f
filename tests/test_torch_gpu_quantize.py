"""K1 and K2 (``csrc/mx_quantize.cu``) in every mode, the RMSNorm kernel
fused with K2 (``csrc/mx_rmsnorm.cu``), the per-row quantize kernel, and K4 /
K6 (``csrc/mx_attention_tile.cuh``) over caches past 65536 positions, on the
card against their plain versions; imports neither JAX nor flax, so the
machine with the card can collect it.  Every case needs an NVIDIA GPU
(marker ``gpu``) and skips elsewhere.  The tests directory's ``conftest.py``
imports JAX, so on a machine without JAX run this file without it:

    python -m pytest tests/test_torch_gpu_quantize.py -m gpu -q --noconftest

Tolerances: K1 and K2 bit for bit over every bf16 pattern in every format
and mode (row-major, B9's dot order, B7's planes, the cache write in both
layouts at int and per-row positions, the fused norm); the fused norm equal
to K2 of the RMSNorm kernel's output bit for bit (the kernel's sum of
squares takes another order than the plain version's, so the norm itself is
held within one bf16 step, as ``chip_smoke.check_rmsnorm_kernel`` holds it);
K4 and K6 at L = 131072 and 262144 under K4's gates (abs <= 2e-2, worst row
and whole output L2 rel <= ``chip_smoke.K4_ROW_REL`` / ``K4_L2_REL``) and K6
equal to K4 bit for bit.
"""

import numpy as np
import pytest
import torch

from torchmx_tpu_torch.models import deepseek as tds
from torchmx_tpu_torch.models.llama import MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_attention as ca
from torchmx_tpu_torch.ops import cuda_lib
from torchmx_tpu_torch.ops import cuda_norm
from torchmx_tpu_torch.ops import cuda_quantize as cq

ELEMS = ["float8_e4m3", "float4_e2m1", "int8", "float6_e3m2", "float6_e2m3"]
CACHE_ELEMS = ["float8_e4m3", "float6_e3m2", "int8", "float4_e2m1"]
R, DR = 512, 64  # the latent and rope-key widths of Moonlight and DeepSeek-V3
ROW_REL, L2_REL = 1.2e-2, 7e-4  # chip_smoke.K4_ROW_REL, K4_L2_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def bits(t) -> np.ndarray:
    f = np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()
    out = f.view(np.int32).copy()
    out[np.isnan(f)] = 0x7FC00000
    return out


def bf16_bits(seed: int, shape) -> np.ndarray:
    """bf16 bit patterns ``shape = (..., rows, w)``: scaled normals, a zero
    row, an inf, a NaN, a row of subnormals only, subnormals beside normals,
    and a row in the largest binade."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * 3)).astype(np.float32)
    b = (x.view(np.uint32) >> 16).astype(np.uint16).reshape(-1, shape[-1])
    w = shape[-1]
    b[0] = 0
    b[1, 3] = 0x7F80
    b[2, 5] = 0xFFC1
    b[3] = rng.integers(1, 128, w) | (rng.integers(0, 2, w) << 15)
    b[4, ::2] = rng.integers(1, 128, w // 2)
    b[5] = 0x7F00 | rng.integers(0, 128, w)
    return b.reshape(shape)


def t_of(b: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)


def all_bf16(device) -> torch.Tensor:
    """Every bf16 bit pattern, as 2048 blocks of 32."""
    b = torch.arange(65536, dtype=torch.int32)
    return torch.where(b >= 32768, b - 65536, b).to(torch.int16).view(torch.bfloat16).reshape(-1, 32).to(device)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, any NaN equal to any NaN."""
    nan = torch.isnan(a.float()) & torch.isnan(b.float())
    return bool(((a.view(torch.int16) == b.view(torch.int16)) | nan).all())


@pytest.mark.gpu
@pytest.mark.parametrize("ename", ELEMS)
def test_cuda_quantize_kernels_bit_exact(cuda_device, ename):
    allbits = torch.arange(65536, dtype=torch.int32)
    x = torch.where(allbits >= 32768, allbits - 65536, allbits).to(torch.int16)
    x = x.view(torch.bfloat16).reshape(-1, 32).to(cuda_device)
    s, c = cq.mx_quantize(x, ename)
    sp, cp = cq.mx_quantize_plain(x, ename)
    assert torch.equal(s, sp) and torch.equal(c.view(torch.uint8), cp.view(torch.uint8))
    fq = cq.mx_fake_quantize_kernel(x, ename)
    fp = cq.mx_fake_quantize_plain(x, ename)
    np.testing.assert_array_equal(bits(fq.cpu()), bits(fp.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("ename", ELEMS)
@pytest.mark.parametrize("shape", [(1, 32), (3, 96), (32, 8, 1, 128), (2048, 4096)])
def test_k1_k2_every_shape_and_grid_stride(cuda_device, ename, shape):
    """K1 and K2 at a block, an odd row count, the decode cache write and a
    prefill activation (more units than the grid's threads: the grid-stride
    loop), every bf16 pattern tiled over the tensor, bit for bit."""
    n = int(np.prod(shape))
    x = all_bf16(cuda_device).reshape(-1).repeat(-(-n // 65536))[:n].reshape(shape).contiguous()
    s, c = cq.mx_quantize(x, ename)
    sp, cp = cq.mx_quantize_plain(x, ename)
    assert torch.equal(s, sp) and torch.equal(c.view(torch.uint8), cp.view(torch.uint8))
    assert same_bits(cq.mx_fake_quantize_kernel(x, ename), cq.mx_fake_quantize_plain(x, ename))


@pytest.mark.gpu
@pytest.mark.parametrize("ename", cq.DOT_FORMATS)
@pytest.mark.parametrize("rows", [1, 17, 128])
def test_dot_order_mode_every_pattern(cuda_device, ename, rows):
    """K1 in B9's dot order over every bf16 pattern as rows of 512 (the pad
    columns of the transposed factors 0)."""
    x = all_bf16(cuda_device).reshape(128, 512)[:rows].contiguous()
    got, want = cq.mx_quantize_dot(x, ename), cq.mx_quantize_dot_plain(x, ename)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1].view(torch.uint8), want[1].view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("act", cq.PLANE_FORMATS)
@pytest.mark.parametrize("K", [512, 160])
def test_plane_mode_every_pattern(cuda_device, act, K):
    """K2's plane mode over every bf16 pattern (K = 160: planes padded)."""
    x = all_bf16(cuda_device).reshape(-1)[:(65536 // K) * K].reshape(-1, K).contiguous()
    assert same_bits(cq.mx_fake_quantize_planes(x, act), cq.mx_fake_quantize_planes_plain(x, act))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["seq", "dmajor"])
@pytest.mark.parametrize("elem", CACHE_ELEMS)
def test_cache_write_matches_plain(cuda_device, elem, layout):
    """The cache write's one launch against its plain version, bit for bit:
    a prompt at an int position, then a decode write of one token a row at
    per-row positions (one clamped at the end, one at 0), then a chunk of 8
    at per-row positions; V given as a transposed view (strided rows)."""
    if elem == "float4_e2m1" and layout == "seq":
        pytest.skip("fp4 caches are ported in the d-major layout only")
    b, kv, L, d = 4, 2, 256, 128
    got = MXLayerKVCache.create(b, kv, L, d, elem, device=cuda_device, layout=layout)
    ref = MXLayerKVCache.create(b, kv, L, d, elem, device=cuda_device, layout=layout)
    pos = torch.tensor([L, 0, 17, 200], dtype=torch.int32, device=cuda_device)
    for seed, s, at in ((1, 64, 3), (2, 1, pos), (3, 8, pos)):
        k = t_of(bf16_bits(seed, (b, kv, s, d))).to(cuda_device)
        v = t_of(bf16_bits(seed + 10, (b, s, kv, d))).to(cuda_device).transpose(1, 2)
        before = cuda_lib.LAUNCHES["mx_quantize"]
        got.write(k, v, at)
        assert cuda_lib.LAUNCHES["mx_quantize"] == before + 1
        cq.mx_cache_write_plain(k, v, ref.buffers, elem, layout, at)
    assert all(torch.equal(x, y) for x, y in zip(got.buffers, ref.buffers))


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "float8_e4m3", "int8", "float6_e3m2", "float4_e2m1"])
@pytest.mark.parametrize("rows", [1, 32, 2048])
@pytest.mark.parametrize("width", [256, 896, 3584, 4096, 7168])
def test_fused_norm_is_k2_of_the_norm(cuda_device, act, rows, width):
    """The RMSNorm kernel with an activation format equals K2 of its own
    output bit for bit (one launch, counted as ``mx_rmsnorm``); its plain
    version is K2's plain version of the plain norm.  Widths: one warp a
    row (256), three and a half warps (896, Qwen2-0.5B's: the CTA's last
    half warp idle), 14 warps (3584, Qwen2-7B's), one vector a thread
    (4096), two for some threads (7168)."""
    g = torch.Generator().manual_seed(rows)
    x = (torch.randn(rows, width, generator=g) * 3).to(torch.bfloat16).to(cuda_device)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(torch.bfloat16).to(cuda_device)
    before = dict(cuda_lib.LAUNCHES)
    fused = cuda_norm.rms_norm(x, w, 1e-5, act)
    assert cuda_lib.LAUNCHES["mx_rmsnorm"] == before.get("mx_rmsnorm", 0) + 1
    assert sum(cuda_lib.LAUNCHES.values()) == sum(before.values()) + 1
    normed = cuda_norm.rms_norm(x, w, 1e-5)
    want = normed if act is None else cq.mx_fake_quantize_kernel(normed, act)
    assert same_bits(fused, want)
    plain = cuda_norm.rms_norm_plain(x, w, 1e-5, act)
    ref = cuda_norm.rms_norm_plain(x, w, 1e-5)
    assert same_bits(plain, ref if act is None else cq.mx_fake_quantize_plain(ref, act))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 896, 3584, 4096, 7168])
def test_norm_rows_alone_and_near_plain(cuda_device, width):
    """Each row of the RMSNorm kernel's output has the same bits alone as
    among 37 rows, and lies within one bf16 step of the plain version's
    (the sum of squares is taken in another fixed order)."""
    g = torch.Generator().manual_seed(width)
    x = (torch.randn(37, width, generator=g) * 3).to(torch.bfloat16).to(cuda_device)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(torch.bfloat16).to(cuda_device)
    out = cuda_norm.rms_norm(x, w, 1e-5)
    for i in (0, 5, 36):
        assert same_bits(cuda_norm.rms_norm(x[i:i + 1], w, 1e-5), out[i:i + 1])
    ref = cuda_norm.rms_norm_plain(x, w, 1e-5).float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert ((out.float() - ref).abs() <= step).all()


@pytest.mark.gpu
@pytest.mark.parametrize("elem", cq.ROW_FORMATS)
def test_cuda_quantize_rows_matches_plain(cuda_device, elem):
    """The kernel in both output modes against its plain version, bit for
    bit, one launch a pair; per-row starts 1020 and 5 over L = 1024 at s = 8
    (the first clamps)."""
    x1, x2 = (t_of(bf16_bits(s, (4, 8, w))).to(cuda_device) for s, w in ((7, R), (8, DR)))
    before = cuda_lib.LAUNCHES["mx_quantize_rows"]
    got = cq.mx_quantize_rows(x1, x2, elem, 0.07)
    assert cuda_lib.LAUNCHES["mx_quantize_rows"] == before + 1
    for g, r in zip(got, cq.mx_quantize_rows_plain(x1, x2, elem, 0.07)):
        assert torch.equal(g, r)
    cache = tds.MXMLACache.create(4, 1024, R, DR, elem, layout="dmajor", device=cuda_device)
    twin = cache.clone()
    pos = torch.tensor([1020, 5, 0, 300], device=cuda_device)
    cq.mx_quantize_rows(x1, x2, elem, out=cache.buffers, pos=pos)
    cq.mx_quantize_rows_plain(x1, x2, elem, out=twin.buffers, pos=pos)
    assert all(torch.equal(a, b) for a, b in zip(cache.buffers, twin.buffers))


def _row_rel(a, b):
    num = (a.double() - b.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / b.double().norm(dim=-1)).max().item()


def _l2_rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 16], ids=["decode", "prefill sq=16"])
@pytest.mark.parametrize("L", [131072, 262144])
def test_long_caches_k4_k6(cuda_device, L, sq):
    """K4 and K6 over caches of 131072 and 262144 positions (shares of 16384
    and 32768, 8 and 16 JAX tiles of 2048 each): against the plain version
    under K4's gates at prefixes across shares, chunks and tiles, K6 equal
    to K4 bit for bit."""
    lt, P, C = ca.attention_tile(L), ca.attention_share(L), ca.ATTN_CHUNK
    kv = [L, P + C + 1, 3 * P + lt + 1, L - 1]
    hkv, hq, d = 1, 4, 128
    g = torch.Generator(cuda_device).manual_seed(L + sq)
    cache = MXLayerKVCache.create(len(kv), hkv, L, d, "int8", device=cuda_device, layout="seq")
    for i in range(len(kv)):  # one row at a time: the bf16 K/V of a row are 64 MiB at L = 262144
        k, v = (torch.randn(1, hkv, L, d, generator=g, device=cuda_device).to(torch.bfloat16) for _ in range(2))
        cq.mx_cache_write(k, v, tuple(t[i:i + 1] for t in cache.buffers), "int8", "seq", 0)
    q = torch.randn(len(kv), hq, sq, d, generator=g, device=cuda_device).to(torch.bfloat16)
    kvt = torch.tensor(kv, dtype=torch.int32, device=cuda_device)
    args = (q, *cache.buffers, kvt - sq, kvt, d ** -0.5, "int8")
    out = ca.mx_cached_attention(*args)
    ref = ca.mx_cached_attention_plain(*args)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_rel(out, ref) <= ROW_REL and _l2_rel(out, ref) <= L2_REL
    dm = (q, *(t.transpose(2, 3).contiguous() for t in cache.buffers), kvt - sq, kvt, d ** -0.5, "int8")
    assert torch.equal(ca.mx_cached_attention_dmajor(*dm), out)
