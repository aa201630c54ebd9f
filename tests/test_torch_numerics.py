"""The PyTorch port's numerics core held bit-exact against the JAX package.

Every bf16 bit pattern (the ``all_bfloat16_values`` fixture plus inf/NaN
blocks) goes through ``torchmx_tpu`` and ``torchmx_tpu_torch``; scales,
codes, dequantized values and fake-quantized values must agree bit for bit
(tolerance: none).  Two block arrangements: sorted (all-subnormal and
single-binade blocks) and a seeded permutation (mixed-magnitude blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmx_tpu import env_variables as jenv
from torchmx_tpu import mx_array as jmx
from torchmx_tpu import packing as jpacking
from torchmx_tpu_torch import env_variables as tenv
from torchmx_tpu_torch import mx_array as tmx
from torchmx_tpu_torch import packing as tpacking
from torchmx_tpu_torch.ops.cuda_quantize import mx_fake_quantize_plain

torch.set_num_threads(1)

ELEMS = ["float8_e4m3", "float4_e2m1", "int8", "float6_e3m2", "float6_e2m3"]


def _to_torch_bf16(x_jnp) -> torch.Tensor:
    bits = np.asarray(jax.lax.bitcast_convert_type(x_jnp, jnp.uint16)).astype(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16/f32 torch tensor -> integer bit patterns, NaNs canonicalised."""
    f = t.to(torch.float32)
    out = f.view(torch.int32).numpy().copy()
    out[np.isnan(f.numpy())] = 0x7FC00000
    return out


def _jbits(a) -> np.ndarray:
    f = np.asarray(a, dtype=np.float32)
    out = f.view(np.int32).copy()
    out[np.isnan(f)] = 0x7FC00000
    return out


@pytest.fixture(params=["sorted", "permuted"])
def domain(request, all_bfloat16_values):
    """(n, 32) bf16 blocks covering every finite bf16 value, plus blocks
    holding +/-inf and NaN."""
    x = np.asarray(all_bfloat16_values)
    if request.param == "permuted":
        x = x[np.random.default_rng(0).permutation(x.shape[0])]
    x = x[: x.shape[0] // 32 * 32].reshape(-1, 32)
    special = np.array([np.inf, -np.inf, np.nan], dtype=np.float32)
    rows = x[:3].astype(np.float32)
    rows[np.arange(3), 5] = special
    x = np.concatenate([x.astype(np.float32), rows]).astype(jnp.bfloat16)
    return jnp.asarray(x)


@pytest.fixture(params=["True", "False"])
def exact_env(request):
    """Both quantizer implementations, in both packages."""
    old_j, old_t = jenv.MX_EXACT_QUANTIZATION, tenv.MX_EXACT_QUANTIZATION
    jenv.MX_EXACT_QUANTIZATION = tenv.MX_EXACT_QUANTIZATION = request.param
    yield request.param
    jenv.MX_EXACT_QUANTIZATION, tenv.MX_EXACT_QUANTIZATION = old_j, old_t


@pytest.mark.parametrize("ename", ELEMS)
def test_quantize_and_dequantize_bit_exact(domain, exact_env, ename):
    j = jmx.MXArray.to_mx(domain, ename, 32)
    t = tmx.MXTensor.to_mx(_to_torch_bf16(domain), ename, 32)
    np.testing.assert_array_equal(t.scale_e8m0.numpy(), np.asarray(j.scale_e8m0))
    np.testing.assert_array_equal(
        t.data.numpy().view(np.uint8), np.asarray(j.data).view(np.uint8)
    )
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            _bits(t.to_dtype(tdt)), _jbits(np.asarray(j.to_dtype(jdt), np.float32))
        )


@pytest.mark.parametrize("ename", ELEMS)
def test_fake_quantize_plain_equals_quantize_dequantize(domain, ename):
    """K2's plain version == the JAX quantize -> dequantize round trip."""
    ref = jmx.MXArray.to_mx(domain, ename, 32).to_dtype(jnp.bfloat16)
    got = mx_fake_quantize_plain(_to_torch_bf16(domain), ename)
    np.testing.assert_array_equal(_bits(got), _jbits(np.asarray(ref, np.float32)))


def test_pack_unpack_uint4_bit_exact():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, size=(6, 64), dtype=np.uint8)
    for dim in (0, 1, -1):
        jp = np.asarray(jpacking.pack_uint4(jnp.asarray(codes), dim))
        tp = tpacking.pack_uint4(torch.from_numpy(codes), dim)
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(tpacking.unpack_uint4(tp, dim).numpy(), codes)


def test_to_fp4_halves_bit_exact():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((96, 128)).astype(np.float32)  # (N, K)
    jw = jmx.MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), "float4_e2m1", 32).T.to_fp4_halves()
    tw = tmx.MXTensor.to_mx(torch.from_numpy(w).to(torch.bfloat16), "float4_e2m1", 32).T.to_fp4_halves()
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(tw.scale_e8m0.numpy(), np.asarray(jw.scale_e8m0))
    np.testing.assert_array_equal(
        _bits(tw.to_dtype(torch.bfloat16)), _jbits(np.asarray(jw.to_dtype(jnp.bfloat16), np.float32))
    )


@pytest.mark.parametrize("ename", ["float8_e4m3", "float6_e3m2", "float6_e2m3", "float4_e2m1"])
def test_reference_goldens(ename):
    """The frozen goldens of the original torch reference implementation."""
    from pathlib import Path

    g = np.load(Path(__file__).parent / "goldens" / "reference_goldens.npz")
    x = torch.from_numpy(g["x_bits"].astype(np.int16)).view(torch.bfloat16)
    t = tmx.MXTensor.to_mx(x, ename, 32)
    np.testing.assert_array_equal(t.scale_e8m0.numpy(), g[f"{ename}_scale"])
    np.testing.assert_array_equal(t.data.numpy(), g[f"{ename}_codes"])
    deq = t.to_dtype(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(deq, g[f"{ename}_deq_bits"])
