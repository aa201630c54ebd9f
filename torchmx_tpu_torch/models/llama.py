"""Llama in PyTorch (``torchmx_tpu/models/llama.py``), bf16 with MX seams.

This port serves one path: generation over an MX KV cache, in the seq or the
d-major layout.  Every attention call writes its K/V into the cache, then
attends causally over the written prefix through ``cached_attention_any``
(which names the kernel each layout, format and query length goes to), or,
where JAX's plan has no kernel for the head_dim, through JAX's eager route
(``cached_attention_eager``), each such call counted by
``ops/fallbacks.note_fallback`` under JAX's key.
``cache_position`` is an int (all rows at one position) or a ``(b,)`` int tensor on the model's
device (continuous batching: every row at its own position); a tensor is
never read back on the host.
Default RoPE only; no sliding window, ring cache or soft caps yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import env_variables as env
from ..layers.linear import Linear
from ..ops.backend import DeviceLike, resolve_device
from ..ops.cuda_attention import cached_attention_any, cached_attention_eager, dequantize_cache
from ..ops.cuda_norm import rms_norm
from ..ops.cuda_quantize import mx_cache_write
from ..ops.fallbacks import note_fallback

CachePosition = Union[int, torch.Tensor]


@dataclasses.dataclass
class LlamaConfig:
    """Architecture hyperparameters (subset of HF ``LlamaConfig``)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    # Bias on q/k/v only (Qwen2); o_proj's bias follows attention_bias alone.
    attention_qkv_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.rope_scaling:
            raise NotImplementedError("only default RoPE is ported")


# -- rotary position embeddings ------------------------------------------------


def rope_inv_freq(config: LlamaConfig, device=None) -> torch.Tensor:
    d = config.head_dim
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (config.rope_theta ** exponents)


def rope_cos_sin(inv_freq: torch.Tensor, position_ids: torch.Tensor, dtype=torch.bfloat16):
    """cos/sin tables ``(*position_ids.shape, head_dim)``."""
    freqs = position_ids[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-convention RoPE on (b, h, s, d) with (b, s, d) cos/sin."""
    cos, sin = cos[:, None], sin[:, None]
    return (q * cos + rotate_half(q) * sin).to(q.dtype), (k * cos + rotate_half(k) * sin).to(k.dtype)


# -- KV cache --------------------------------------------------------------------


class MXLayerKVCache:
    """MX-quantized per-layer KV cache, quantized along head_dim, in one of
    two storage layouts (``layout``; default ``env.TORCHMX_KV_LAYOUT``):

    * ``"seq"``: codes ``(b, kv, L, d)`` and scales ``(b, kv, L, d/32)``;
    * ``"dmajor"``: codes ``(b, kv, dp, L)`` and scales ``(b, kv, d/32, L)``,
      the sequence on the last, contiguous axis.  ``dp`` is ``d``, or ``d/2``
      for fp4, whose bytes pack d-halves: byte ``p`` holds element ``p`` in
      its high nibble and element ``p + d/2`` in its low nibble.

    fp4 caches exist in the d-major layout only.  ``write`` updates the
    buffers in place (JAX returned a new cache; in place saves a copy of the
    cache per token)."""

    def __init__(self, k_data, k_scale, v_data, v_scale, elem_dtype_name: str, block_size: int = 32,
                 layout: str = "seq"):
        if layout not in ("seq", "dmajor"):
            raise ValueError(f"unknown KV cache layout {layout!r}")
        self.k_data, self.k_scale = k_data, k_scale
        self.v_data, self.v_scale = v_data, v_scale
        self.elem_dtype_name = elem_dtype_name
        self.block_size = block_size
        self.layout = layout

    @staticmethod
    def create(batch, kv_heads, max_len, head_dim, elem_dtype_name="float8_e4m3",
               block_size=32, device=None, layout: Optional[str] = None) -> "MXLayerKVCache":
        if layout is None:
            layout = env.TORCHMX_KV_LAYOUT
        fp4 = elem_dtype_name == "float4_e2m1"
        if fp4 and layout == "seq":
            raise NotImplementedError("fp4 KV caches are ported in the d-major layout only")
        payload = torch.int8 if elem_dtype_name == "int8" else torch.uint8
        dp, nb = (head_dim // 2 if fp4 else head_dim), head_dim // block_size
        if layout == "dmajor":
            data, scale = (batch, kv_heads, dp, max_len), (batch, kv_heads, nb, max_len)
        else:
            data, scale = (batch, kv_heads, max_len, dp), (batch, kv_heads, max_len, nb)

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return MXLayerKVCache(z(data, payload), z(scale, torch.uint8), z(data, payload),
                              z(scale, torch.uint8), elem_dtype_name, block_size, layout)

    @property
    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return self.k_data, self.k_scale, self.v_data, self.v_scale

    def clone(self) -> "MXLayerKVCache":
        return MXLayerKVCache(*(t.clone() for t in self.buffers), self.elem_dtype_name,
                              self.block_size, self.layout)

    @property
    def max_len(self) -> int:
        """Sequence capacity, whatever the layout."""
        return self.k_data.shape[3 if self.layout == "dmajor" else 2]

    def write(self, k_new: torch.Tensor, v_new: torch.Tensor, pos: CachePosition) -> None:
        """Quantize ``(b, kv, s, d)`` K/V and store them at sequence positions
        ``[pos, pos + s)``: ``pos`` is an int, or a ``(b,)`` int tensor on the
        cache's device with one start per row.  On the card one K1 launch
        writes both into the four buffers (``ops/cuda_quantize.mx_cache_write``).

        A per-row start that would run past the buffer is clamped to
        ``max_len - s``, as XLA clamps ``dynamic_update_slice`` in the
        reference (the engine's draining slots write at ``pos == max_len``);
        an index past the end would be a device-side assert on the card.  In
        the d-major layout the sequence is the last axis, so a token's codes
        land ``max_len`` bytes apart."""
        if self.block_size != 32:
            raise ValueError(f"the MX KV cache takes block size 32, got {self.block_size}")
        mx_cache_write(k_new.to(torch.bfloat16), v_new.to(torch.bfloat16), self.buffers, self.elem_dtype_name,
                       self.layout, pos)

    def dequantize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full dequantized (k, v) buffers ``(b, kv, L, d)`` in either layout
        (plain path and tests)."""
        return tuple(dequantize_cache(d, s, self.elem_dtype_name, self.layout)
                     for d, s in ((self.k_data, self.k_scale), (self.v_data, self.v_scale)))


# -- modules ---------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.bfloat16, device=device), requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        """The row-wise kernel on the card (a row's bytes do not depend on
        the other rows), the plain version on the CPU (``ops/cuda_norm``);
        with ``act`` (an activation format), fake-quantized to it in the same
        launch."""
        return rms_norm(x, self.weight, self.eps, act)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with every step rounded to the input dtype, the
    reference's bf16 arithmetic (exp, add, divide, multiply each rounded)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        h, i, b = config.hidden_size, config.intermediate_size, config.mlp_bias
        kw = dict(use_bias=b, device=device, generator=generator)
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    """GQA attention with RoPE over an MX KV cache."""

    def __init__(self, config: LlamaConfig, layer_idx: int = 0, device=None, generator=None):
        super().__init__()
        self.config, self.layer_idx = config, layer_idx
        self.num_heads = config.num_attention_heads
        self.num_key_value_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        self.sm_scale = 1.0 / math.sqrt(config.head_dim)
        h, d = config.hidden_size, config.head_dim
        qkv_bias = config.attention_bias or config.attention_qkv_bias
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(h, self.num_heads * d, use_bias=qkv_bias, **kw)
        self.k_proj = Linear(h, self.num_key_value_heads * d, use_bias=qkv_bias, **kw)
        self.v_proj = Linear(h, self.num_key_value_heads * d, use_bias=qkv_bias, **kw)
        self.o_proj = Linear(self.num_heads * d, h, use_bias=config.attention_bias, **kw)

    def _project_qkv(self, x, x_fq=None):
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def forward(self, hidden=None, *, cos, sin, cache: MXLayerKVCache, cache_position: CachePosition, x_fq=None):
        """``x_fq``: the input already fake-quantized to q/k/v's shared
        activation grid (an MX module's ``shared_act``), given in place of
        ``hidden``."""
        b, s, _ = (hidden if x_fq is None else x_fq).shape
        q, k, v = self._project_qkv(hidden, x_fq)
        q = q.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)
        k = k.view(b, s, self.num_key_value_heads, self.head_dim).transpose(1, 2)
        v = v.view(b, s, self.num_key_value_heads, self.head_dim).transpose(1, 2)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        cache.write(k, v, cache_position)
        out = cached_attention_any(q, cache, cache_position, cache_position + s, self.sm_scale)
        if out is None:  # no kernel in JAX's plan for this head_dim: JAX's eager route, counted as JAX counts it
            note_fallback("cached_attention", f"q{tuple(q.shape)} cache{tuple(cache.k_data.shape)} "
                                              f"{cache.elem_dtype_name}")
            out = cached_attention_eager(q, cache, cache_position)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, -1))


class LlamaDecoderLayer(nn.Module):
    # Extension points of sibling families (Mistral, Mixtral).
    attention_cls = LlamaAttention
    mlp_cls = LlamaMLP

    def __init__(self, config: LlamaConfig, layer_idx: int, device=None, generator=None):
        super().__init__()
        self.self_attn = type(self).attention_cls(config, layer_idx, device, generator)
        self.mlp = type(self).mlp_cls(config, device, generator)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)

    def forward(self, x, *, cos, sin, cache, cache_position):
        x = x + _normed_into(self.input_layernorm, self.self_attn, x, cos=cos, sin=sin, cache=cache,
                             cache_position=cache_position)
        return x + _normed_into(self.post_attention_layernorm, self.mlp, x)


def _normed_into(norm: RMSNorm, module: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """``module(norm(x))``.  Where the module's linears share one activation
    fake-quantize at x's rows (an MX module's ``shared_act``), the norm
    applies it in the same launch and the module takes the result as
    ``x_fq``: the same bits, without the norm's output written and read
    back."""
    shared_act = getattr(module, "shared_act", None)
    act = shared_act(x.numel() // x.shape[-1]) if shared_act is not None else None
    if act is None:
        return module(norm(x), **kw)
    return module(x_fq=norm(x, act), **kw)


class LlamaModel(nn.Module):
    layer_cls = LlamaDecoderLayer  # extension point

    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        emb = torch.zeros((config.vocab_size, config.hidden_size), dtype=torch.bfloat16, device=device)
        if generator is not None:
            emb = (torch.randn(emb.shape, generator=generator, device=device) * 0.02).to(torch.bfloat16)
        self.embed_tokens = nn.Parameter(emb, requires_grad=False)
        self.layers = nn.ModuleList(
            type(self).layer_cls(config, i, device, generator) for i in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.register_buffer("inv_freq", rope_inv_freq(config, device), persistent=False)

    def forward(self, input_ids, *, caches: List[MXLayerKVCache], cache_position: CachePosition,
                position_ids=None):
        b, s = input_ids.shape
        x = self.embed_tokens[input_ids]
        if position_ids is None and isinstance(cache_position, torch.Tensor):
            position_ids = cache_position[:, None] + torch.arange(s, device=x.device)
        elif position_ids is None:
            position_ids = torch.arange(cache_position, cache_position + s, device=x.device)[None].expand(b, s)
        cos, sin = rope_cos_sin(self.inv_freq, position_ids, x.dtype)
        for layer, cache in zip(self.layers, caches):
            x = layer(x, cos=cos, sin=sin, cache=cache, cache_position=cache_position)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Entry point.  ``device`` defaults to ``cuda`` (raising when there is
    none); pass ``device="cpu"`` for the plain PyTorch path, or ``"meta"`` to
    allocate nothing (layers are then filled in one by one).  With a
    ``generator`` the weights are seeded random, else zeros."""

    model_cls = LlamaModel  # extension point

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.model = type(self).model_cls(config, device, generator)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, device=device, generator=generator
        )

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.device

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return F.linear(hidden.float(), self.model.embed_tokens.float()).to(hidden.dtype)
        return self.lm_head(hidden)

    def forward(self, input_ids, *, caches, cache_position: CachePosition, position_ids=None,
                last_only=False):
        """Logits ``(b, s, vocab)`` bf16 (``last_only``: of the last position)."""
        hidden = self.model(input_ids, caches=caches, cache_position=cache_position,
                            position_ids=position_ids)
        return self.logits(hidden[:, -1:] if last_only else hidden)

    def init_cache(self, batch: int, max_len: int, kv_cache_config) -> List[MXLayerKVCache]:
        if kv_cache_config is None:
            raise NotImplementedError("a bf16 KV cache is not ported; pass an MX kv_cache_config")
        c = self.config
        return [
            MXLayerKVCache.create(batch, c.num_key_value_heads, max_len, c.head_dim,
                                  kv_cache_config.elem_dtype_name, kv_cache_config.block_size,
                                  device=self.device)
            for _ in range(c.num_hidden_layers)
        ]
