"""B7 on K3's mainloop (``mx_matmul_fp4_pair``): the plane-order K2 and the
kernel's arithmetic held against the JAX package on the same numpy inputs
(JAX on the CPU, ``_pallas_matmul_fp4`` in interpret mode), its launch plan,
and the rule that sends x through K2 first.

The kernel reads x as ``[even K | odd K]`` planes, each zero-padded to
``pair_width(K) / 2`` columns, that K2 writes (fake-quantized at the joint
scale of each 32-element block of the row, or copied), and multiplies the
pair bytes' high nibbles against the even plane and their low nibbles
against the odd one.  Tolerances: the planes bit for bit (JAX's
``_fq_xT_pair`` is the same quantize); the emulated kernel against the Pallas
kernel and against plain B7 rel <= 1e-2 (max abs over max abs, K3's: the sums
run in another K order).  The CUDA kernel itself is held to plain B7 on the
card (``tests/test_torch_mla.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmx_tpu.mx_array import MXArray
from torchmx_tpu.ops import pallas_matmul as jpm
from torchmx_tpu_torch.config import MXConfig, QLinearConfig
from torchmx_tpu_torch.layers.linear import MXInferenceLinear, fq_layout, shared_activation_fq
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.ops import cuda_lib, cuda_matmul
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
from torchmx_tpu_torch.ops import cuda_quantize as cq

torch.set_num_threads(1)

# K of the pair layout's callers: short and ragged K (64, 96, 160; K % 128 !=
# 0 pads the planes), Qwen2-0.5B's hidden and intermediate (896, 4864), 992
# (the largest K % 128 != 0 JAX's plan serves whole) and Moonlight's shared
# down_proj (2816).
PAIR_KS = (64, 96, 160, 896, 992, 2816, 4864)


def bf16(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def t_bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def spread_x(seed: int, M: int, K: int) -> np.ndarray:
    """Activations whose 32-blocks have scales far apart (as K2's chip check
    draws them), so that a scale over 16 elements of one plane would differ
    from the joint one."""
    rng = np.random.default_rng(seed)
    return bf16(rng.standard_normal((M, K)) * np.exp2(np.round(rng.standard_normal((M, K)) * 3)))


# -- K2 in plane order --------------------------------------------------------------------------


@pytest.mark.parametrize("K", PAIR_KS)
@pytest.mark.parametrize("act", ["float8_e4m3", "int8"])
def test_plane_fq_matches_jax_joint_scale(act, K):
    """The plane mode's plain version against JAX's ``_fq_xT_pair(xe.T,
    xo.T, act)``, bit for bit, with the padding zero."""
    x = spread_x(K + 1, 8, K)
    xe, xo = jnp.asarray(x[:, 0::2], jnp.bfloat16), jnp.asarray(x[:, 1::2], jnp.bfloat16)
    je, jo = jpm._fq_xT_pair(xe.T, xo.T, act)
    got = cq.mx_fake_quantize_planes_plain(t_bf16(x), act)
    half = cq.pair_width(K) // 2
    assert got.shape == (8, 2 * half) and half % 64 == 0
    want = np.zeros((8, 2 * half), np.int16)
    want[:, :K // 2] = np.asarray(je.T).view(np.int16)
    want[:, half:half + K // 2] = np.asarray(jo.T).view(np.int16)
    np.testing.assert_array_equal(bits(got), want)


@pytest.mark.parametrize("K", PAIR_KS)
def test_plane_copy_splits_even_and_odd(K):
    """The copy mode (``act_fq=None``): ``x[:, 0::2]`` then ``x[:, 1::2]``,
    each zero-padded; the wrapper on a CPU tensor is the plain version."""
    x = t_bf16(spread_x(K, 5, K))
    got = cq.mx_fake_quantize_planes(x)
    half = cq.pair_width(K) // 2
    want = torch.zeros((5, 2 * half), dtype=torch.bfloat16)
    want[:, :K // 2], want[:, half:half + K // 2] = x[:, 0::2], x[:, 1::2]
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(cq.mx_fake_quantize_planes_plain(x, None)), bits(want))


def test_plane_mode_takes_b7s_formats_only():
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="plane mode"):
        cq.mx_fake_quantize_planes(x, "float4_e2m1")
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- the kernel's arithmetic -------------------------------------------------------------------


def kernel_emulation(x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, act):
    """What the CUDA kernel computes, in plain PyTorch: K2's planes, the
    high nibbles (decoded at scale row p / 16 of packed row p) against the
    even plane plus the low nibbles against the odd plane, over the padded
    planes' width (W's rows past K/2 zeros), fp32 sums, one bf16 rounding."""
    planes = cq.mx_fake_quantize_planes_plain(x, act).float()
    half = planes.shape[1] // 2
    b = w_data.to(torch.int32)
    se = w_scale.to(torch.int32).repeat_interleave(16, dim=0)
    w = torch.zeros((2, half, b.shape[1]), dtype=torch.float32)
    w[0, :b.shape[0]] = cuda_matmul.decode_fp4_to_bf16(b >> 4, se).float()
    w[1, :b.shape[0]] = cuda_matmul.decode_fp4_to_bf16(b & 0xF, se).float()
    return (planes[:, :half] @ w[0] + planes[:, half:] @ w[1]).to(torch.bfloat16)


def rel(a: torch.Tensor, b) -> float:
    a, b = a.float().numpy(), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("act", [None, "float8_e4m3", "int8"])
@pytest.mark.parametrize("K", (96, 160, 896, 4864))
def test_kernel_arithmetic_matches_pallas_kernel(K, act):
    """The emulated kernel against ``_pallas_matmul_fp4`` (interpret mode;
    the whole K as one block up to 1024, as JAX's plan takes it, else
    256-element blocks) and against plain B7, rel <= 1e-2."""
    M, N = 16, 128
    rng = np.random.default_rng(K)
    x = bf16(rng.standard_normal((M, K)))
    w = bf16(rng.standard_normal((N, K)) * 0.05)
    jw = MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), "float4_e2m1", 32).T
    tw = MXTensor.to_mx(t_bf16(w), "float4_e2m1", 32).T
    assert jw.fp4_pack == tw.fp4_pack == "pair"
    bk = K if K <= 1024 else 256
    ref = np.asarray(jpm._pallas_matmul_fp4(jnp.asarray(x, jnp.bfloat16), jw.data, jw.scale_e8m0, N, bk,
                                            jnp.bfloat16, act), np.float32)
    got = kernel_emulation(t_bf16(x), tw.data, tw.scale_e8m0, act)
    assert rel(got, ref) <= 1e-2
    assert rel(got, kf.mx_matmul_fp4_pair_plain(t_bf16(x), tw.data, tw.scale_e8m0, act).float().numpy()) <= 1e-2


# -- the launch plan ---------------------------------------------------------------------------

# (N, K) of B7's callers: Moonlight's shared down_proj, Qwen2-0.5B's gate/up
# and down, short and ragged K, N % 128 != 0.
PAIR_NK = [(2048, 2816), (4864, 896), (896, 4864), (2048, 160), (128, 64), (1024, 992)]


@pytest.mark.parametrize("N,K", PAIR_NK)
def test_b7_plan_keeps_the_splits_at_every_m(N, K):
    """``plan_pair`` over M = 1..4096 on a 132-SM card: the splits are
    ``k_splits(N, pair_width(K), 132, 128)`` at every M (K itself where K %
    128 == 0), the tile and stage count are K3's at every M, the shared
    memory fits a block, a single split is never walked."""
    plans = [kf.plan_pair(M, N, K, 132) for M in range(1, 4097)]
    assert {p.splits for p in plans} == {cuda_matmul.k_splits(N, cq.pair_width(K), 132, 128)}
    assert {(p.bm, p.bn, p.stages) for p in plans} == {(cuda_matmul.K3_BM, cuda_matmul.K3_BN, cuda_matmul.K3_STAGES)}
    assert all(p.smem_bytes <= kf.SMEM_LIMIT and p.smem_bytes == cuda_matmul.k3_smem_bytes("float4_e2m1")
               for p in plans)
    assert all(not p.walk for p in plans if p.splits == 1)
    if K % 128 == 0:
        assert plans == [cuda_matmul.plan_halves(M, N, K, 132) for M in range(1, 4097)]


# -- the activation quantize comes first ---------------------------------------------------------


def test_act_fq_first_by_layout():
    """B7, B8 and K3 take x from K2 at every M; B6 above 64 rows only."""
    for rows in range(1, 300):
        assert all(kf.act_fq_first(layout, rows) for layout in ("pair", "quarters", "halves"))
        assert kf.act_fq_first("1byte", rows) == (rows > kf.ACT_FQ_FUSE_MAX_M)


def _linear(K: int, elem: str, seed: int) -> MXInferenceLinear:
    w = (torch.randn(256, K, generator=torch.Generator().manual_seed(seed)) * 0.05).to(torch.bfloat16)
    return MXInferenceLinear.from_weights(w, None, QLinearConfig(MXConfig(elem), MXConfig("float8_e4m3")))


@pytest.mark.parametrize("rows", [1, 32, 100])
def test_shared_fq_keeps_pair_weights_out(rows):
    """A group of pair linears (K % 512 != 0) gets no shared row-major K2 at
    any M (each B7 writes its own planes); halves share at every M, B6 above
    64 rows."""
    pair = [_linear(896, "float4_e2m1", s) for s in (1, 2)]
    halves = [_linear(512, "float4_e2m1", s) for s in (3, 4)]
    flat = [_linear(896, "int8", s) for s in (5, 6)]
    assert [fq_layout(lin.weight) for lin in (pair[0], halves[0], flat[0])] == ["pair", "halves", "1byte"]
    x = torch.randn(rows, 896).to(torch.bfloat16)
    assert shared_activation_fq(x, *pair) is None
    assert (shared_activation_fq(x, *flat) is None) == (rows <= kf.ACT_FQ_FUSE_MAX_M)
    assert shared_activation_fq(torch.randn(rows, 512).to(torch.bfloat16), *halves) is not None


def test_b7_wrapper_checks_before_any_launch():
    """On CPU tensors the wrapper is plain B7; an activation format it does
    not take raises before anything runs."""
    w = MXTensor.to_mx(torch.randn(128, 160).to(torch.bfloat16), "float4_e2m1").T
    x = torch.randn(3, 160).to(torch.bfloat16)
    got = kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, "int8")
    assert torch.equal(got, kf.mx_matmul_fp4_pair_plain(x, w.data, w.scale_e8m0, "int8"))
    with pytest.raises(ValueError, match="act_fq"):
        kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, "float6_e3m2")
    assert sum(cuda_lib.LAUNCHES.values()) == 0
