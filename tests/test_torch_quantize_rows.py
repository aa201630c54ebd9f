"""The port's per-row MX quantizer (``ops/cuda_quantize.mx_quantize_rows``:
one E8M0 exponent per row, block = the row's width) held against the JAX
package on the same numpy inputs: its plain version against JAX's
``quantize_mx(x, elem, w)`` and against JAX's d-major ``MXMLACache.write``;
the MX MLA layer's one activation quantize for its two input projections
against each linear quantizing its own x.  On a machine with a card, the
kernel against its plain version.

Tolerances: none.  Codes, scales and cache buffers bit-equal; the shared
activation quantize gives the projections' bytes unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmx_tpu.models import deepseek as jds
from torchmx_tpu.mx_array import quantize_mx as jquantize_mx
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.layers import linear
from torchmx_tpu_torch.layers.mx_deepseek_attention import MXInferenceMLAAttention
from torchmx_tpu_torch.models import deepseek as tds
from torchmx_tpu_torch.ops import cuda_lib
from torchmx_tpu_torch.ops import cuda_quantize as cq

torch.set_num_threads(1)

R, DR = 512, 64  # the latent and rope-key widths of Moonlight and DeepSeek-V3


def bf16_bits(seed: int, shape) -> np.ndarray:
    """bf16 bit patterns ``shape = (..., rows, w)``: scaled normals, a zero
    row, an inf, a NaN, a row of subnormals only, subnormals beside normals,
    and a row in the largest binade."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * 3)).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16).reshape(-1, shape[-1])
    w = shape[-1]
    bits[0] = 0
    bits[1, 3] = 0x7F80
    bits[2, 5] = 0xFFC1
    bits[3] = rng.integers(1, 128, w) | (rng.integers(0, 2, w) << 15)
    bits[4, ::2] = rng.integers(1, 128, w // 2)
    bits[5] = 0x7F00 | rng.integers(0, 128, w)
    return bits.reshape(shape)


def t_of(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def j_of(bits: np.ndarray):
    return jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)


@pytest.mark.parametrize("w1,w2", [(R, DR), (DR, R)], ids=["w512-64", "w64-512"])
@pytest.mark.parametrize("elem", cq.ROW_FORMATS)
def test_quantize_rows_matches_jax(elem, w1, w2):
    """Row-major output (B14's query form) at sm_scale 1: the codes are JAX's
    ``quantize_mx(x, elem, w)`` codes and the f32 row scale is the float
    whose bits are JAX's E8M0 exponent << 23, bit for bit, for both inputs
    of the pair."""
    b1, b2 = bf16_bits(1, (2, 8, w1)), bf16_bits(2, (2, 8, w2))
    c1, s1, c2, s2 = cq.mx_quantize_rows(t_of(b1), t_of(b2), elem)
    for bits, codes, scale in ((b1, c1, s1), (b2, c2, s2)):
        js, jd = jquantize_mx(j_of(bits), elem, bits.shape[-1])
        assert str(codes.dtype).split(".")[-1] == str(np.asarray(jd).dtype)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jd))
        np.testing.assert_array_equal((scale.view(torch.int32) >> 23).numpy(), np.asarray(js, np.int32)[..., 0])
        assert torch.equal(scale, ((scale.view(torch.int32) >> 23) << 23).view(torch.float32))


@pytest.mark.parametrize("positions", ["int", "per-row-clamped"])
@pytest.mark.parametrize("elem", cq.ROW_FORMATS)
def test_dmajor_write_matches_jax(elem, positions):
    """The d-major store over a cache a prefill of 8 positions filled: 4 new
    positions at int start 7 through ``MXMLACache.write`` (a device tensor
    made by ``torch.full``), or at per-row starts 30 and 3 by
    ``mx_quantize_rows_plain`` (30 + 4 > 32 clamps to 28, as XLA's
    ``dynamic_update_slice``): every buffer bit-equal to JAX's."""
    B, L = 2, 32
    pre = [bf16_bits(3, (B, 8, R)), bf16_bits(4, (B, 8, DR))]
    new = [bf16_bits(5, (B, 4, R)), bf16_bits(6, (B, 4, DR))]
    jc = jds.MXMLACache.create(B, L, R, DR, elem, 32, layout="dmajor").write(*map(j_of, pre), 0)
    tc = tds.MXMLACache.create(B, L, R, DR, elem, layout="dmajor")
    tc.write(*map(t_of, pre), 0)
    if positions == "int":
        jc = jc.write(*map(j_of, new), 7)
        tc.write(*map(t_of, new), 7)
    else:
        pos = np.array([30, 3], np.int32)
        jc = jc.write(*map(j_of, new), jnp.asarray(pos))
        assert cq.mx_quantize_rows_plain(*map(t_of, new), elem, out=tc.buffers, pos=torch.from_numpy(pos)) is None
    for name, t in zip(("lat_data", "lat_scale", "rot_data", "rot_scale"), tc.buffers):
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jc, name)), err_msg=name)
    with pytest.raises(ValueError, match="cannot take positions up to"):
        tc.write(*map(t_of, new), L - 3)


@pytest.mark.parametrize("M", [1, 32])
@pytest.mark.parametrize("q_lora_rank", [None, 512], ids=["q_proj", "q_a-q_b"])
def test_mla_inputs_share_one_activation_quantize(q_lora_rank, M):
    """With fp4 halves weights (hidden 512) the MX MLA layer fake-quantizes x
    once for its first query projection and ``kv_a_proj_with_mqa`` (one K2
    on the card, was two), and both projections keep the bytes each linear
    gives quantizing its own x."""
    cfg = tds.DeepseekV3Config(vocab_size=64, hidden_size=512, intermediate_size=256, num_hidden_layers=1,
                               num_attention_heads=4, num_key_value_heads=4, q_lora_rank=q_lora_rank,
                               kv_lora_rank=R, qk_rope_head_dim=DR, qk_nope_head_dim=32, v_head_dim=32)
    mod = tds.MLAAttention(cfg, 0, generator=torch.Generator().manual_seed(3))
    q = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    layer = MXInferenceMLAAttention.from_float(mod, QAttentionConfig(q))
    first = layer.q_a_proj if q_lora_rank else layer.q_proj
    assert {first.weight.fp4_pack, layer.kv_a_proj_with_mqa.weight.fp4_pack} == {"halves"}
    x = (torch.randn(2, M, 512, generator=torch.Generator().manual_seed(4)) * 2).to(torch.bfloat16)
    shared, fq = [], linear.mx_fake_quantize

    def spy(*a, **k):
        shared.append(a[0].shape)
        return fq(*a, **k)

    linear.mx_fake_quantize = spy
    try:
        got = layer._project_inputs(x)
    finally:
        linear.mx_fake_quantize = fq
    assert shared == [(2, M, 512)]
    ref = tds.MLAAttention._project_inputs(layer, x)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
