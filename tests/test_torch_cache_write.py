"""K1's cache write (``ops/cuda_quantize.mx_cache_write``) and the RMSNorm
fused with K2 (``ops/cuda_norm.rms_norm(..., act)``) on the CPU: their plain
versions against the JAX package, bit for bit, and what the layers launch.

* ``mx_cache_write_plain`` equals JAX's ``MXLayerKVCache.write``
  (``torchmx_tpu/models/llama.py``) byte for byte, compared through
  ``convert.cache_from_buffers``, for fp8, fp6 e3m2, int8 and fp4 (d-major),
  in both layouts, at an int position and at per-row positions with one row
  clamped at ``max_len`` (XLA clamps ``dynamic_update_slice``).
* The fused norm's plain version equals ``mx_fake_quantize_plain(
  rms_norm_plain(x))`` bit for bit, and the decoder layer that uses it gives
  the same bits as one that norms and quantizes apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmx_tpu.models.llama import MXLayerKVCache as JCache
from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig
from torchmx_tpu_torch.convert import cache_from_buffers
from torchmx_tpu_torch.models import llama as tl
from torchmx_tpu_torch.models.llama import LlamaConfig, MXLayerKVCache
from torchmx_tpu_torch.ops import cuda_lib, cuda_norm
from torchmx_tpu_torch.ops import cuda_quantize as cq
from torchmx_tpu_torch.quant_api import build_quantized_llama

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

NAMES = ("k_data", "k_scale", "v_data", "v_scale")
CASES = [(e, lay) for e in ("float8_e4m3", "float6_e3m2", "int8") for lay in ("seq", "dmajor")]
CASES += [("float4_e2m1", "dmajor")]


def rand_bf16(seed, shape) -> np.ndarray:
    """Gaussian values of log-normal spread, float32 holding bf16 values,
    with a zero, an inf and a subnormal planted."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp2(rng.standard_normal(shape) * 3)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    flat = x.reshape(-1)
    flat[:3] = (0.0, np.inf, 2.0 ** -130)
    return x


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("per_row", [False, True], ids=["int position", "per-row positions"])
@pytest.mark.parametrize("elem, layout", CASES)
def test_cache_write_plain_matches_jax(elem, layout, per_row):
    """A prompt of 8 at position 4, then a decode write of one token a row
    (per row: the first row at max_len, clamped to max_len - 1), then a chunk
    of 3: the port's plain write leaves the JAX cache's bytes."""
    b, h, L, d = 3, 2, 64, 64
    jc = JCache.create(b, h, L, d, elem, 32, layout=layout)
    tc = MXLayerKVCache.create(b, h, L, d, elem, device="cpu", layout=layout)
    steps = [(8, 4), (1, [L, 9, 0] if per_row else 12), (3, [20, L - 3, 5] if per_row else 13)]
    for i, (s, pos) in enumerate(steps):
        k, v = rand_bf16(10 * i, (b, h, s, d)), rand_bf16(10 * i + 1, (b, h, s, d))
        jp = jnp.asarray(pos, jnp.int32)
        jc = jc.write(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), jp)
        cq.mx_cache_write_plain(to_torch(k), to_torch(v), tc.buffers, elem, layout,
                                torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos)
    ref = cache_from_buffers(*(np.asarray(getattr(jc, n)) for n in NAMES), elem, layout, device="cpu")
    for got, want in zip(tc.buffers, ref.buffers):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_cache_write_is_the_cache_path():
    """``MXLayerKVCache.write`` goes through the cache write (the plain
    version on the CPU, no launch); a V given as a transposed view takes the
    same bytes as a contiguous one; bad positions raise."""
    b, h, L, d = 2, 2, 32, 64
    k = to_torch(rand_bf16(1, (b, h, 4, d)))
    v = to_torch(rand_bf16(2, (b, 4, h, d))).transpose(1, 2)
    a = MXLayerKVCache.create(b, h, L, d, "int8", device="cpu", layout="dmajor")
    c = MXLayerKVCache.create(b, h, L, d, "int8", device="cpu", layout="dmajor")
    cuda_lib.reset_launch_counts()
    a.write(k, v, 3)
    cq.mx_cache_write_plain(k, v.contiguous(), c.buffers, "int8", "dmajor", 3)
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    assert all(torch.equal(x, y) for x, y in zip(a.buffers, c.buffers))
    for pos in (L - 3, -1, torch.zeros(b + 1, dtype=torch.int32)):
        with pytest.raises(ValueError):
            a.write(k, v, pos)


@pytest.mark.parametrize("act", [None, "float8_e4m3", "int8", "float6_e3m2", "float4_e2m1"])
def test_fused_norm_plain_is_k2_of_the_norm(act):
    x = to_torch(rand_bf16(3, (5, 512)))
    w = to_torch(1 + 0.1 * rand_bf16(4, (512,)).clip(-10, 10))
    got = cuda_norm.rms_norm(x, w, 1e-5, act)
    norm = cuda_norm.rms_norm_plain(x, w, 1e-5)
    want = norm if act is None else cq.mx_fake_quantize_plain(norm, act)
    nan = torch.isnan(got.float()) & torch.isnan(want.float())
    assert bool(((got.view(torch.int16) == want.view(torch.int16)) | nan).all())


def _model(weights, acts):
    cfg = LlamaConfig(vocab_size=256, hidden_size=1024, intermediate_size=2048, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=2, head_dim=128)
    q = QLinearConfig(MXConfig(weights), MXConfig(acts))
    return build_quantized_llama(cfg, QAttentionConfig(q), q, "cpu", torch.Generator().manual_seed(0))


@pytest.mark.parametrize("weights, acts, fused", [("float4_e2m1", "float8_e4m3", True),
                                                  ("float6_e3m2", "float8_e4m3", True),
                                                  ("int8", "int8", False)])
def test_layers_fuse_the_shared_fake_quantize_into_the_norm(monkeypatch, weights, acts, fused):
    """Where q/k/v and gate/up share one K2 at every M (fp4 halves, fp6
    quarters), each decoder layer's two norms take the activation format and
    no K2 runs for them; where B9 takes the linears (W8A8 at decode), the
    norms do not, and q/k/v and gate/up each share one K1 (dot order).  The
    logits equal those of the same model with the fusion and the sharing
    turned off, bit for bit."""
    model = _model(weights, acts)
    acts_seen, k1_dot = [], []
    norm = tl.rms_norm
    monkeypatch.setattr(tl, "rms_norm", lambda x, w, eps, act=None: (acts_seen.append(act), norm(x, w, eps, act))[1])
    quantize_dot = cq.mx_quantize_dot
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    monkeypatch.setattr(kf, "mx_quantize_dot", lambda x, e: (k1_dot.append(x.shape), quantize_dot(x, e))[1])
    ids = torch.randint(0, 256, (2, 1), generator=torch.Generator().manual_seed(1))
    caches = model.init_cache(2, 128, MXConfig("int8"))
    got = model(ids, caches=caches, cache_position=5)
    layers = model.config.num_hidden_layers
    assert acts_seen == [acts if fused else None] * (2 * layers) + [None]
    if not fused:  # q/k/v and gate/up: one K1 each a layer (the others quantize their own x)
        assert len(k1_dot) == 2 * layers
    from torchmx_tpu_torch.layers import mx_llama_attention as mla
    monkeypatch.setattr(mla, "_shared_act", lambda rows, *linears: None)
    monkeypatch.setattr(mla, "shared_int8dot_x", lambda x, *linears: None)
    monkeypatch.setattr(mla, "shared_activation_fq", lambda x, *linears: None)
    caches = model.init_cache(2, 128, MXConfig("int8"))
    ref = model(ids, caches=caches, cache_position=5)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
