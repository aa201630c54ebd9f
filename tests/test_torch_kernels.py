"""The plain PyTorch versions of the port's four kernels held against the JAX
Pallas kernels they replace (interpret mode, small shapes), and, on a
machine with a card, the CUDA kernels against their plain versions.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
quantize and fake-quantize bit-exact; matmul rel <= 1e-2 (max abs
difference over max abs output: only the fp32 accumulation order differs);
attention abs <= 2e-2 (the JAX kernel takes 256-position tiles at L = 256,
the port 64: p rounds to bf16 against different running maxima).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmx_tpu import env_variables as jenv
from torchmx_tpu.mx_array import MXArray, quantize_mx as jquantize_mx
from torchmx_tpu.ops import pallas_attention as jpa
from torchmx_tpu.ops import pallas_matmul as jpm
from torchmx_tpu.ops import pallas_quantize as jpq
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_attention, cuda_matmul, cuda_quantize

torch.set_num_threads(1)

ELEMS = ["float8_e4m3", "float4_e2m1", "int8", "float6_e3m2", "float6_e2m3"]


def rand_bf16(seed, shape, spread=3.0) -> np.ndarray:
    """Gaussian values with log-normal magnitude spread, as float32 holding
    bf16-representable values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * spread)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def bits(t) -> np.ndarray:
    f = np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()
    out = f.view(np.int32).copy()
    out[np.isnan(f)] = 0x7FC00000
    return out


@pytest.fixture
def pallas_env():
    old = jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = "pallas", "pallas"
    yield
    jenv.TORCHMX_QUANTIZE_BACKEND, jenv.TORCHMX_FUSED_ATTENTION = old


@pytest.mark.parametrize("ename", ELEMS)
def test_mx_quantize_plain_matches_pallas_kernel(ename):
    x = rand_bf16(2, (128, 128))
    s_ref, c_ref = jpq.quantize_mx_pallas(jnp.asarray(x, jnp.bfloat16), ename, 32)
    s, c = cuda_quantize.mx_quantize_plain(to_torch(x), ename)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(c.numpy().view(np.uint8), np.asarray(c_ref).view(np.uint8))


@pytest.mark.parametrize("ename", ELEMS)
def test_mx_fake_quantize_plain_matches_pallas_kernel(ename):
    x = rand_bf16(3, (128, 128))
    x[0, 0] = np.nan
    x[1, :32] = 0.0
    ref = jpq.fake_quantize_pallas(jnp.asarray(x, jnp.bfloat16), ename, 32)
    got = cuda_quantize.mx_fake_quantize_plain(to_torch(x), ename)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("M", [8, 96])
@pytest.mark.parametrize("act_fq", [None, "float8_e4m3"])
def test_mx_matmul_fp4_halves_plain_matches_pallas_kernel(M, act_fq):
    K, N = 512, 256
    x = rand_bf16(4, (M, K), spread=1.0)
    w = (np.random.default_rng(5).standard_normal((N, K)) * 0.05).astype(np.float32)
    jw = MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), "float4_e2m1", 32).T.to_fp4_halves()
    ref = jpm.matmul_any(jnp.asarray(x, jnp.bfloat16), jw, jnp.bfloat16, act_fq=act_fq)
    tw = MXTensor.to_mx(to_torch(w), "float4_e2m1", 32).T.to_fp4_halves()
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    got = cuda_matmul.mx_matmul_fp4_halves_plain(to_torch(x), tw.data, tw.scale_e8m0, act_fq)
    r = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - r).max() / np.abs(r).max()
    assert err <= 1e-2, err


def test_unfused_activation_formats_take_two_passes():
    """K3 fuses only fp8 activations and rejects other formats; with an fp6
    activation ``mx_dynamic_matmul`` fake-quantizes first and then runs K3
    without ``act_fq``, matching the Pallas kernel's fused fp6 (rel <= 1e-2)."""
    from torchmx_tpu_torch.ops.matmul import mx_dynamic_matmul

    M, K, N = 8, 512, 256
    x = rand_bf16(9, (M, K), spread=1.0)
    w = (np.random.default_rng(10).standard_normal((N, K)) * 0.05).astype(np.float32)
    jw = MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), "float4_e2m1", 32).T.to_fp4_halves()
    ref = np.asarray(jpm.matmul_any(jnp.asarray(x, jnp.bfloat16), jw, jnp.bfloat16,
                                    act_fq="float6_e3m2"), np.float32)
    tw = MXTensor.to_mx(to_torch(w), "float4_e2m1", 32).T.to_fp4_halves()
    with pytest.raises(ValueError, match="act_fq"):
        cuda_matmul.mx_matmul_fp4_halves(to_torch(x), tw.data, tw.scale_e8m0, "float6_e3m2")
    got = mx_dynamic_matmul(to_torch(x), tw, "float6_e3m2")
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-2, err


def _fp8_cache(seed, b, hkv, L, d):
    rng = np.random.default_rng(seed)
    k = np.asarray(jnp.asarray(rng.standard_normal((b, hkv, L, d)), jnp.bfloat16))
    v = np.asarray(jnp.asarray(rng.standard_normal((b, hkv, L, d)), jnp.bfloat16))
    ks, kd = jquantize_mx(jnp.asarray(k), "float8_e4m3", 32)
    vs, vd = jquantize_mx(jnp.asarray(v), "float8_e4m3", 32)
    return types.SimpleNamespace(
        k_data=kd, k_scale=ks, v_data=vd, v_scale=vs, elem_dtype_name="float8_e4m3",
        block_size=32, layout="seq",
    )


@pytest.mark.parametrize("sq", [1, 16])
def test_mx_cached_attention_plain_matches_pallas_kernel(pallas_env, sq):
    b, hq, hkv, d, L = 2, 4, 2, 128, 256
    cache = _fp8_cache(6, b, hkv, L, d)
    q = rand_bf16(7, (b, hq, sq, d), spread=0.5)
    q_off = np.array([3, 200 - sq], np.int32)  # ragged rows
    kv_len = q_off + sq
    ref = jpa.cached_attention_any(jnp.asarray(q, jnp.bfloat16), cache, jnp.asarray(q_off),
                                   jnp.asarray(kv_len), d ** -0.5)
    assert ref is not None
    t = {k: torch.from_numpy(np.array(getattr(cache, k))) for k in ("k_data", "k_scale", "v_data", "v_scale")}
    got = cuda_attention.mx_cached_attention_plain(
        to_torch(q), t["k_data"], t["k_scale"], t["v_data"], t["v_scale"],
        torch.from_numpy(q_off), torch.from_numpy(kv_len), d ** -0.5, "float8_e4m3",
    )
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= 2e-2, err


def test_wrappers_take_the_plain_path_on_cpu():
    """On a CPU tensor a wrapper returns its plain version's result and
    launches nothing."""
    from torchmx_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launch_counts()
    x = to_torch(rand_bf16(8, (4, 64)))
    s, c = cuda_quantize.mx_quantize(x, "float8_e4m3")
    sp, cp = cuda_quantize.mx_quantize_plain(x, "float8_e4m3")
    assert torch.equal(s, sp) and torch.equal(c, cp)
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- the CUDA kernels (need a card) --------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ename", ELEMS)
def test_cuda_quantize_kernels_bit_exact(cuda_device, ename):
    allbits = torch.arange(65536, dtype=torch.int32)
    x = torch.where(allbits >= 32768, allbits - 65536, allbits).to(torch.int16)
    x = x.view(torch.bfloat16).reshape(-1, 32).to(cuda_device)
    s, c = cuda_quantize.mx_quantize(x, ename)
    sp, cp = cuda_quantize.mx_quantize_plain(x, ename)
    assert torch.equal(s, sp) and torch.equal(c.view(torch.uint8), cp.view(torch.uint8))
    fq = cuda_quantize.mx_fake_quantize_kernel(x, ename)
    fp = cuda_quantize.mx_fake_quantize_plain(x, ename)
    np.testing.assert_array_equal(bits(fq.cpu()), bits(fp.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 32, 256])
def test_cuda_matmul_kernel_matches_plain(cuda_device, M):
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(1024, 512, generator=g) * 0.05).to(torch.bfloat16)
    tw = MXTensor.to_mx(w.to(cuda_device), "float4_e2m1", 32).T.to_fp4_halves()
    x = torch.randn(M, 512, generator=g).to(torch.bfloat16).to(cuda_device)
    out = cuda_matmul.mx_matmul_fp4_halves(x, tw.data, tw.scale_e8m0, "float8_e4m3")
    ref = cuda_matmul.mx_matmul_fp4_halves_plain(x, tw.data, tw.scale_e8m0, "float8_e4m3")
    assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 64])
def test_cuda_attention_kernel_matches_plain(cuda_device, sq):
    b, hq, hkv, d, L = 2, 8, 2, 128, 256
    g = torch.Generator().manual_seed(1)
    k = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(cuda_device)
    v = torch.randn(b, hkv, L, d, generator=g).to(torch.bfloat16).to(cuda_device)
    ks, kd = cuda_quantize.mx_quantize(k, "float8_e4m3")
    vs, vd = cuda_quantize.mx_quantize(v, "float8_e4m3")
    q = torch.randn(b, hq, sq, d, generator=g).to(torch.bfloat16).to(cuda_device)
    q_off = torch.tensor([0, 150], dtype=torch.int32, device=cuda_device)
    args = (q, kd, ks, vd, vs, q_off, q_off + sq, d ** -0.5, "float8_e4m3")
    out = cuda_attention.mx_cached_attention(*args)
    ref = cuda_attention.mx_cached_attention_plain(*args)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
