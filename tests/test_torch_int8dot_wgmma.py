"""B9 (``_int8dot_kernel``) as the port runs it on Hopper, held against the
JAX package on the same numpy inputs, on the CPU:

(a) K1's dot-order mode (``cuda_quantize.mx_quantize_dot_plain``): JAX's
    ``quantize_mx`` codes permuted into ``DOT_ORDER`` inside each block and
    its scales transposed to ``(K/32, Mp)``, bit for bit, in int8 and e4m3,
    over zero blocks, infinities, NaN, subnormals and the top binade;
(b) a torch model of the kernel's arithmetic (dot-order codes, exact block
    sums, the magic-number int32 -> f32 conversion, ``(s * px) * pw`` added in
    block order, ``k_splits`` summed in split order): for int8 it gives B6's
    arithmetic (per-block partials of the decoded operands, the same order)
    bit for bit, the plain B9 and the plain B6 with int8 ``act_fq`` bit for
    bit where the f32 sums are exact (every order gives the same sum) and
    within one bf16 step on random inputs (the orders differ in f32
    rounding); e4m3 within one bf16 step of the plain B9; both within the
    JAX package's own int8-dot tolerance (rtol / atol 1e-2) of
    ``_pallas_matmul_int8dot`` in interpret mode, as
    ``tests/test_torch_formats.py::test_int8dot_plain_matches_pallas_kernel``;
(c) ``plan_int8dot`` keeps B6's splits, tile and walk at every M up to 256;
(d) the wrapper and K1's dot-order mode raise on what they do not take,
    before any launch; a served call is two host calls, K1's and B9's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmx_tpu.mx_array import MXArray, quantize_mx
from torchmx_tpu.ops import pallas_matmul as jpm
from torchmx_tpu_torch.mx_array import MXTensor
from torchmx_tpu_torch.mx_quantization import f32_from_bits
from torchmx_tpu_torch.ops import cuda_lib, cuda_matmul_formats as kf
from torchmx_tpu_torch.ops import cuda_quantize as cq
from torchmx_tpu_torch.ops.cuda_matmul import k_splits

torch.set_num_threads(1)

SMS = 132  # an H100's SMs: the splits the kernel takes there
FORMATS = ("int8", "float8_e4m3")


def rand_bf16(seed, shape, spread=1.0, scale=1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * spread) * scale
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def bf16_of_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16)


# -- (a) K1's dot-order mode -------------------------------------------------------------------


def special_rows(M: int, K: int, seed: int) -> np.ndarray:
    """bf16 bit patterns (M, K): random values over a wide range, with a zero
    block, +/-inf, NaN, subnormals and top-binade values in other blocks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)) * np.exp2(rng.integers(-20, 20, (M, 1)))
    bits = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16).copy()
    bits[0, 32:64] = 0  # a zero block
    bits[1 % M, 5] = 0x7F80  # +inf
    bits[2 % M, 40] = 0xFF80  # -inf
    bits[3 % M, 70] = 0x7FC0  # NaN
    bits[4 % M, 96:128] = rng.integers(1, 0x80, 32) | (rng.integers(0, 2, 32) << 15)  # subnormals
    bits[5 % M, 128:160] = 0x7F00 | rng.integers(0, 0x80, 32) | (rng.integers(0, 2, 32) << 15)  # top binade
    bits[6 % M, 160:192] = rng.integers(1, 0x80, 32)  # subnormals beside a normal value
    bits[6 % M, 170] = 0x3F80
    return bits


@pytest.mark.parametrize("M", [1, 17, 40])
@pytest.mark.parametrize("fmt", FORMATS)
def test_dot_order_plain_is_jax_quantize_permuted(fmt, M):
    K = 256
    bits = special_rows(M, K, 3 + M)
    js, jc = quantize_mx(jnp.asarray(bits).view(jnp.bfloat16), fmt, 32)
    js, jc = np.asarray(js), np.asarray(jc).view(np.uint8)
    px_t, codes = cq.mx_quantize_dot_plain(bf16_of_bits(bits), fmt)
    Mp = cq.dot_scale_width(M)
    assert Mp % 16 == 0 and M <= Mp < M + 16
    want_t = np.zeros((K // 32, Mp), np.int32)
    want_t[:, :M] = js.T.astype(np.int32) << 23  # the f32 factor 2^(se - 127), +0 for se = 0
    assert px_t.dtype == torch.float32
    np.testing.assert_array_equal(px_t.view(torch.int32).numpy(), want_t)
    want = jc.reshape(M, K // 32, 32)[:, :, list(cq.DOT_ORDER)].reshape(M, K)
    np.testing.assert_array_equal(codes.view(torch.uint8).numpy(), want)
    assert codes.dtype == (torch.int8 if fmt == "int8" else torch.uint8)
    np.testing.assert_array_equal(cq.from_dot_order(codes).view(torch.uint8).numpy(), jc)


def test_dot_order_is_where_ldmatrix_puts_w():
    """Position 4q + j of a 16-group holds element 2q + (j & 1) + 8 (j >> 1):
    the K of byte j of the A register that one byte permute of two
    ldmatrix.x4.trans matrices (K 2q, 2q + 1 and 8 + 2q, 9 + 2q) makes."""
    for h in range(2):
        for q in range(4):
            for j in range(4):
                assert cq.DOT_ORDER[16 * h + 4 * q + j] == 16 * h + 2 * q + (j & 1) + 8 * (j >> 1)
    assert sorted(cq.DOT_ORDER) == list(range(32))


# -- (b) the kernel's arithmetic -----------------------------------------------------------------


def code_values(codes: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return codes.view(torch.uint8).view(torch.float8_e4m3fn).double()
    return codes.view(torch.int8).long()


def kernel_emulation(xd, px_t, w, sw, fp8: bool, splits: int) -> torch.Tensor:
    """The new kernel's arithmetic: each block's dot on the codes as they
    meet in the kernel (x in dot order, W's rows under the same
    permutation), int8 exact in int32 and converted by the magic number
    (__int_as_float(0x4B400000 + s) - 1.5 * 2^23), e4m3 rounded once to f32;
    acc += (s * px) * pw in block order within a split (64 K a stage; px
    K1's f32 factors), the splits' accumulators added in split order, one
    bf16 rounding.  The kernel fuses the last multiply and add, which rounds
    alike wherever (s * px) * pw is normal, as on these inputs."""
    M, K = xd.shape
    N, nb = w.shape[1], K // 32
    order = torch.tensor(cq.DOT_ORDER)
    xv = code_values(xd, fp8).reshape(M, nb, 32)
    wv = code_values(w, fp8).reshape(nb, 32, N)[:, order, :]
    if fp8:
        s = torch.einsum("mbk,bkn->bmn", xv, wv).float()
    else:
        si = torch.einsum("mbk,bkn->bmn", xv, wv).to(torch.int32)
        assert int(si.abs().max()) < 2 ** 22
        s = (si + 0x4B400000).view(torch.float32) - 12582912.0
    px = px_t[:, :M]  # (nb, M): K1's f32 factors 2^(sx - 127)
    pw = f32_from_bits(sw.to(torch.int32) << 23)  # (nb, N)
    stages = K // 64
    per = -(-stages // splits)
    total = torch.zeros((M, N), dtype=torch.float32)
    for sp in range(splits):
        acc = torch.zeros((M, N), dtype=torch.float32)
        for b in range(2 * sp * per, 2 * min(stages, (sp + 1) * per)):
            acc = acc + (s[b] * px[b][:, None]) * pw[b][None, :]
        total = total + acc
    return total.to(torch.bfloat16)


def b6_emulation(x, w, sw, splits: int) -> torch.Tensor:
    """B6's arithmetic for int8 codes with int8 act_fq: each block's partial
    from the decoded operands (x fake-quantized by K2's plain version, W by
    the dot-operand decode), the same block and split order."""
    M, K = x.shape
    N, nb = w.shape[1], K // 32
    xq = cq.mx_fake_quantize_plain(x, "int8").double().reshape(M, nb, 32)
    wq = kf.dequantize_1byte(w, sw, "int8").double().reshape(nb, 32, N)
    p = torch.einsum("mbk,bkn->bmn", xq, wq).float()
    stages, total = K // 64, torch.zeros((M, N), dtype=torch.float32)
    per = -(-stages // splits)
    for sp in range(splits):
        acc = torch.zeros((M, N), dtype=torch.float32)
        for b in range(2 * sp * per, 2 * min(stages, (sp + 1) * per)):
            acc = acc + p[b]
        total = total + acc
    return total.to(torch.bfloat16)


def one_bf16_step(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126))) - 7)
    return bool(((a - b).abs() <= ulp).all())


def weights(seed, K, N, fmt, exact=False):
    """The same weight quantized K-major by both packages (W (K, N) codes,
    (K/32, N) scales); ``exact``: every block's largest magnitude in [1, 2),
    so every block shares one scale."""
    w = rand_bf16(seed, (N, K), spread=0.5, scale=0.05)
    if exact:
        w = pinned_blocks(seed, (N, K))
    return MXArray.to_mx(jnp.asarray(w, jnp.bfloat16), fmt, 32).T, MXTensor.to_mx(to_torch(w), fmt, 32).T


def pinned_blocks(seed, shape) -> np.ndarray:
    """Values below 1.5 in magnitude with one element of 1.5 in every 32-block:
    all blocks quantize at one scale, so every block sum is an integer
    multiple of one power of two and their f32 sums are exact."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(shape) * 0.5, -1.4, 1.4)
    x.reshape(-1, 32)[:, 7] = 1.5
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


CASES = [(1, 256, 512), (17, 512, 256), (32, 1024, 128), (64, 256, 512), (65, 512, 256), (128, 1024, 128),
         (129, 256, 512), (256, 512, 256)]  # (M, K, N)


@pytest.mark.parametrize("M,K,N", CASES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_arithmetic_against_plain_b9_b6_and_jax(fmt, M, K, N):
    fp8 = fmt == "float8_e4m3"
    splits = k_splits(N, K, SMS)
    x_np = rand_bf16(20 + M, (M, K))
    jw, tw = weights(21 + M, K, N, fmt)
    x = to_torch(x_np)
    px_t, xd = cq.mx_quantize_dot_plain(x, fmt)
    emu = kernel_emulation(xd, px_t, tw.data, tw.scale_e8m0, fp8, splits)
    sx, xc = cq.mx_quantize_plain(x, fmt)
    plain = kf.mx_matmul_int8dot_plain(xc, sx, tw.data, tw.scale_e8m0, fp8)
    assert one_bf16_step(emu, plain)
    # the port's wrapper on CPU tensors: K1 then the plain B9
    assert torch.equal(kf.mx_matmul_int8dot(x, tw.data, tw.scale_e8m0, fp8), plain)
    if not fp8:
        assert torch.equal(emu, b6_emulation(x, tw.data, tw.scale_e8m0, splits))
        assert one_bf16_step(emu, kf.mx_matmul_1byte_plain(x, tw.data, tw.scale_e8m0, "int8", "int8"))
    jw = jw if fp8 else jw.to_int8_domain()
    run = jpm.fp8dot_any if fp8 else jpm.int8dot_any
    ref = np.asarray(run(jnp.asarray(x_np, jnp.bfloat16), jw, jnp.bfloat16), np.float32)
    np.testing.assert_allclose(emu.float().numpy(), ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("M,K,N", CASES[::2])
def test_int8_kernel_arithmetic_is_plain_b9_and_b6_where_sums_are_exact(M, K, N):
    """On inputs whose f32 sums are exact in any order, the kernel's
    arithmetic, the plain B9 and the plain B6 (one fp32 matmul) give the same
    bytes: the split and block order change rounding only."""
    x = to_torch(pinned_blocks(30 + M, (M, K)))
    _, tw = weights(31 + M, K, N, "int8", exact=True)
    assert len(set(tw.scale_e8m0.flatten().tolist())) == 1
    px_t, xd = cq.mx_quantize_dot_plain(x, "int8")
    assert len(set(px_t[:, :M].flatten().tolist())) == 1  # one x scale too
    emu = kernel_emulation(xd, px_t, tw.data, tw.scale_e8m0, False, k_splits(N, K, SMS))
    sx, xc = cq.mx_quantize_plain(x, "int8")
    assert torch.equal(emu, kf.mx_matmul_int8dot_plain(xc, sx, tw.data, tw.scale_e8m0))
    assert torch.equal(emu, kf.mx_matmul_1byte_plain(x, tw.data, tw.scale_e8m0, "int8", "int8"))


# -- (c) the plan ----------------------------------------------------------------------------------

# (N, K) of the paths' B9 calls: Llama-3-8B's q/o, k/v, gate/up, down and
# lm_head, and the 2-layer test models' K = 512.
B9_NK = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256, 4096), (1024, 512)]


@pytest.mark.parametrize("N,K", B9_NK)
def test_plan_int8dot_keeps_b6_splits(N, K):
    """B9's plan over M = 1..256 on a 132-SM card: B6's splits (the same
    split order), B6's column tile, 64 rows a tile at every M, the shared
    memory within a block's; a CTA walks its splits where the output tiles
    make half a wave (the same bytes as the two-pass form)."""
    for M in range(1, kf.INT8DOT_MAX_M + 1):
        b9, b6 = kf.plan_int8dot(M, N, K, SMS), kf.plan_1byte(M, N, K, SMS)
        assert (b9.splits, b9.bn) == (b6.splits, b6.bn) and b9.splits == k_splits(N, K, SMS)
        assert (b9.bm, b9.stages) == (kf.B9_BM, kf.B9_STAGES) == (64, 8)
        assert b9.smem_bytes == kf.b9_smem_bytes() <= kf.SMEM_LIMIT
        tiles = -(-M // 64) * -(-N // 128)
        assert b9.walk == (b9.splits > 1 and 2 * tiles >= SMS)
        if M <= 64:  # one row tile: B6's plan exactly
            assert b9.walk == b6.walk


# -- (d) the wrapper's checks ------------------------------------------------------------------------


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


BAD_CALLS = {
    "M=0": lambda x, w, s: (x[:0], w, s, False),
    "M=257": lambda x, w, s: (torch.zeros(257, x.shape[1], dtype=torch.bfloat16), w, s, False),
    "K%64": lambda x, w, s: (x[:, :96].contiguous(), w[:96].contiguous(), s[:3].contiguous(), False),
    "N%64": lambda x, w, s: (x, w[:, :96].contiguous(), s[:, :96].contiguous(), False),
    "uint8 codes as int8": lambda x, w, s: (x, w.view(torch.uint8), s, False),
    "int8 codes as e4m3": lambda x, w, s: (x, w, s, True),
    "scale shape": lambda x, w, s: (x, w, s[:-1].contiguous(), False),
    "non-contiguous": lambda x, w, s: (x, w.t().contiguous().t(), s, False),
    "misaligned": lambda x, w, s: (x, _misaligned(w), s, False),
    "x not bf16": lambda x, w, s: (x.float(), w, s, False),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_wrapper_raises_before_any_launch(monkeypatch, case):
    """With the tensors taken for CUDA tensors, every call the kernel does
    not take raises ValueError before K1 or B9 would launch."""
    _, tw = weights(40, 256, 128, "int8")
    x = to_torch(rand_bf16(41, (8, 256)))
    args = BAD_CALLS[case](x, tw.data, tw.scale_e8m0)
    monkeypatch.setattr(kf, "on_cuda", lambda *t: True)
    cuda_lib.reset_launch_counts()
    with pytest.raises(ValueError):
        kf.mx_matmul_int8dot(*args)
    assert sum(cuda_lib.LAUNCHES.values()) == 0


BAD_DOT_ORDER_CALLS = {
    "fp6 codes": lambda x: (x, "float6_e3m2"),
    "fp4 codes": lambda x: (x, "float4_e2m1"),
    "3-D x": lambda x: (x.reshape(2, 4, 64), "int8"),
    "x not bf16": lambda x: (x.float(), "int8"),
    "K % 32": lambda x: (x[:, :48].contiguous(), "float8_e4m3"),
}


@pytest.mark.parametrize("case", list(BAD_DOT_ORDER_CALLS))
def test_dot_order_mode_raises_before_any_launch(monkeypatch, case):
    """K1's dot-order mode, taken for a CUDA call, raises ValueError on
    what it does not write, before it would launch."""
    args = BAD_DOT_ORDER_CALLS[case](to_torch(rand_bf16(44, (8, 64))))
    monkeypatch.setattr(cq, "on_cuda", lambda *t: True)
    cuda_lib.reset_launch_counts()
    with pytest.raises(ValueError):
        cq.mx_quantize_dot(*args)
    assert sum(cuda_lib.LAUNCHES.values()) == 0


@pytest.mark.parametrize("N,K", B9_NK[:4])
@pytest.mark.parametrize("fmt", FORMATS)
def test_served_call_is_two_host_calls(monkeypatch, fmt, N, K):
    """Taken for a CUDA call at the decoder's B9 shapes, the wrapper makes
    two host calls, K1's dot-order mode and B9, whose call also launches the
    split reduce where the plan has one: a workspace of the plan's splits
    where the CTAs do not walk them, none where they do."""
    fp8 = fmt == "float8_e4m3"
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda src, fn, *a, **k: calls.append((fn, a)))
    monkeypatch.setattr(kf, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cq, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kf, "sm_count", lambda device: SMS)
    monkeypatch.setattr(cq, "_sms", lambda device: SMS)  # K1 sizes its grid from the SM count too
    w = torch.empty((K, N), dtype=torch.uint8 if fp8 else torch.int8)
    s = torch.empty((K // 32, N), dtype=torch.uint8)
    for M in (1, 32, 65, 256):
        calls.clear()
        out = kf.mx_matmul_int8dot(to_torch(rand_bf16(45, (M, K))), w, s, fp8)
        assert out.shape == (M, N) and out.dtype == torch.bfloat16
        plan = kf.plan_int8dot(M, N, K, SMS)
        assert [fn for fn, _ in calls] == ["mx_quantize_dot_launch", kf._b9_fn(fp8) + "_launch"]
        splits, walk, reduce, ws = calls[1][1][-3], calls[1][1][-2], calls[1][1][-1], calls[1][1][5]
        assert (splits, walk, reduce) == (plan.splits, int(plan.walk), 1)
        assert (ws is None) == (plan.walk or plan.splits == 1)
