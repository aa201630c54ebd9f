"""DeepSeek-V3 in PyTorch (``torchmx_tpu/models/deepseek.py``): multi-head
latent attention (MLA) over a latent cache, and the noaux-tc routed MoE with
shared experts.

This port serves the cached, **absorbed** form of MLA: the latent and the
rope key of every token are written into the cache, ``kv_b_proj``'s K half
folds into the query and its V half into the output, and attention runs
against the latent itself (``ops/cuda_mla.mla_cached_attention``: B13 over
the seq layout, B14 over the int8 d-major layout, JAX's eager route
elsewhere).  The expanded cacheless form is not ported.  The two absorbed
products run in float64 and are rounded once to bf16: every product of two
bf16 values is exact there and the sums are too in all but pathological
cases, so a row's result does not depend on how many rows share the call
(the engine's whole = chunked = prefixed identity), where an f32 library
product would pick its summation order by shape.

The MoE reuses the Mixtral block (dense-exact, capacity and grouped modes)
through its ``_route_raw`` seam: sigmoid scores from an f32 router
(``ops/cuda_moe.mx_router_logits(..., f32=True)``, row-wise on the card), a
correction bias that steers the choice only, group-limited top-k, the
weights gathered from the raw scores, renormalised and scaled by
``routed_scaling_factor`` (``route_noaux_tc``); the shared experts (a dense
SwiGLU) are added.  Layers below ``first_k_dense_replace`` have a dense MLP.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import torch
from torch import nn

from .. import env_variables as env
from ..layers.linear import Linear
from ..mx_array import dequantize_mx, quantize_mx
from ..ops import cuda_moe
from ..ops.cuda_mla import mla_cached_attention
from ..ops.cuda_quantize import mx_quantize_rows
from ..packing import fp4_halves_to_pairs, fp4_pairs_to_halves
from .llama import (
    CachePosition,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    RMSNorm,
    apply_rotary_pos_emb,
)
from .mixtral import MixtralSparseMoeBlock


@dataclasses.dataclass
class DeepseekV3Config(LlamaConfig):
    """DeepSeek-V3 hyperparameters (subset of HF ``DeepseekV3Config``).
    ``head_dim`` is forced to ``qk_rope_head_dim``, so that the shared rotary
    tables come out at the rope width; ``rope_scaling`` (YaRN) raises."""

    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    rope_interleave: bool = True
    n_routed_experts: int = 8
    n_shared_experts: int = 1
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 256
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 0
    num_local_experts: int = 0  # the Mixtral block's name, set from n_routed_experts

    def __post_init__(self):
        self.head_dim = self.qk_rope_head_dim
        self.num_local_experts = self.n_routed_experts
        super().__post_init__()

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# -- latent caches -----------------------------------------------------------------------------


def _write_rows(buf: torch.Tensor, new: torch.Tensor, pos: CachePosition) -> None:
    """Store ``new (b, s, x)`` into ``buf (b, L, x)`` at sequence positions
    ``[pos, pos + s)``, in place.  A per-row start past the buffer is clamped
    to ``L - s``, as XLA clamps ``dynamic_update_slice``."""
    s, L = new.shape[1], buf.shape[1]
    if isinstance(pos, torch.Tensor):
        b = buf.shape[0]
        if pos.shape != (b,) or pos.device != buf.device:
            raise ValueError(f"per-row positions must be a ({b},) tensor on {buf.device}, "
                             f"got {tuple(pos.shape)} on {pos.device}")
        if s > L:
            raise ValueError(f"cache of length {L} cannot take {s} positions")
        rows = torch.arange(b, device=buf.device)[:, None]
        cols = pos.long().clamp(0, L - s)[:, None] + torch.arange(s, device=buf.device)
        buf[rows, cols] = new.to(buf.dtype)
        return
    _check_int_position(pos, s, L)
    buf.narrow(1, pos, s).copy_(new)


def _check_int_position(pos: int, s: int, L: int) -> None:
    if pos + s > L:
        raise ValueError(f"cache of length {L} cannot take positions up to {pos + s}")


class MLACache:
    """The bf16 per-layer latent cache: ``latent (b, L, kv_lora_rank)`` and
    the shared rope key ``k_rot (b, L, qk_rope_head_dim)``.  ``write``
    updates in place."""

    def __init__(self, latent: torch.Tensor, k_rot: torch.Tensor):
        self.latent, self.k_rot = latent, k_rot

    @staticmethod
    def create(batch: int, max_len: int, kv_lora_rank: int, qk_rope_head_dim: int, device=None) -> "MLACache":
        z = lambda w: torch.zeros((batch, max_len, w), dtype=torch.bfloat16, device=device)  # noqa: E731
        return MLACache(z(kv_lora_rank), z(qk_rope_head_dim))

    @property
    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return self.latent, self.k_rot

    def clone(self) -> "MLACache":
        return MLACache(self.latent.clone(), self.k_rot.clone())

    @property
    def max_len(self) -> int:
        return self.latent.shape[1]

    def write(self, latent_new: torch.Tensor, k_rot_new: torch.Tensor, pos: CachePosition) -> None:
        _write_rows(self.latent, latent_new.to(torch.bfloat16), pos)
        _write_rows(self.k_rot, k_rot_new.to(torch.bfloat16), pos)

    def read(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.latent, self.k_rot


class MXMLACache:
    """MX-quantized latent cache: codes + E8M0 scales of the latent and of
    the rope key, in one of two layouts (``layout``):

    * ``"seq"``: codes ``(b, L, w)`` and scales ``(b, L, w/32)`` for each
      stream; fp4 codes are halves-packed per stream (``(b, L, w/2)``, byte
      ``j`` holding elements ``j`` and ``j + w/2``).  One quantize (K1 on the
      card) over ``[latent | k_rot]`` per write;
    * ``"dmajor"``: codes ``(b, w, L)`` and per-position scales ``(b, 1, L)``
      (one exponent over a position's whole latent, and one over its rope
      key), the layout of B14; one launch of the per-row quantize kernel
      (``ops/cuda_quantize.mx_quantize_rows``, block = w) per write on the
      card, which stores the codes in place.

    ``layout=None`` takes ``TORCHMX_KV_LAYOUT``, except that an fp4 cache
    stays seq; fp4 d-major is refused.  ``write`` updates in place."""

    def __init__(self, lat_data, lat_scale, rot_data, rot_scale, elem_dtype_name: str, block_size: int = 32,
                 layout: str = "seq"):
        self.lat_data, self.lat_scale = lat_data, lat_scale
        self.rot_data, self.rot_scale = rot_data, rot_scale
        self.elem_dtype_name, self.block_size, self.layout = elem_dtype_name, block_size, layout

    @staticmethod
    def create(batch: int, max_len: int, kv_lora_rank: int, qk_rope_head_dim: int,
               elem_dtype_name: str = "int8", block_size: int = 32, layout: Optional[str] = None,
               device=None) -> "MXMLACache":
        fp4 = elem_dtype_name == "float4_e2m1"
        if layout is None:
            layout = "seq" if fp4 else env.TORCHMX_KV_LAYOUT
            if layout == "dmajor" and env.TORCHMX_ATTN_INT8_DOT != "1":
                warnings.warn("TORCHMX_KV_LAYOUT=dmajor without TORCHMX_ATTN_INT8_DOT=1: the d-major latent "
                              "cache is read by the eager dequantize route, not by an attention kernel")
        if layout not in ("seq", "dmajor"):
            raise ValueError(f"unknown MLA cache layout {layout!r}")
        r, dr = kv_lora_rank, qk_rope_head_dim
        if r % block_size or dr % block_size:
            raise ValueError(f"MX MLA cache needs kv_lora_rank ({r}) and qk_rope_head_dim ({dr}) divisible by "
                             f"block_size ({block_size})")
        if fp4 and layout == "dmajor":
            raise ValueError("fp4 MLA caches use the seq layout (the int8-dot d-major kernel reads raw int8 codes)")
        if fp4 and (r % 64 or dr % 64):
            raise ValueError(f"fp4 halves packing needs widths divisible by 64, got kv_lora_rank={r} "
                             f"qk_rope_head_dim={dr}")
        pdt = torch.int8 if elem_dtype_name == "int8" else torch.uint8
        pack = 2 if fp4 else 1

        def mk(w):
            if layout == "dmajor":
                return (torch.zeros((batch, w, max_len), dtype=pdt, device=device),
                        torch.zeros((batch, 1, max_len), dtype=torch.uint8, device=device))
            return (torch.zeros((batch, max_len, w // pack), dtype=pdt, device=device),
                    torch.zeros((batch, max_len, w // block_size), dtype=torch.uint8, device=device))

        return MXMLACache(*mk(r), *mk(dr), elem_dtype_name, block_size, layout)

    @property
    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return self.lat_data, self.lat_scale, self.rot_data, self.rot_scale

    def clone(self) -> "MXMLACache":
        return MXMLACache(*(t.clone() for t in self.buffers), self.elem_dtype_name, self.block_size, self.layout)

    @property
    def max_len(self) -> int:
        return self.lat_data.shape[2 if self.layout == "dmajor" else 1]

    def _pack(self, codes: torch.Tensor) -> torch.Tensor:
        """fp4: pair-packed (the quantizer's output) -> d-halves bytes."""
        return fp4_pairs_to_halves(codes) if self.elem_dtype_name == "float4_e2m1" else codes

    def _unpack(self, data: torch.Tensor) -> torch.Tensor:
        return fp4_halves_to_pairs(data) if self.elem_dtype_name == "float4_e2m1" else data

    def write(self, latent_new: torch.Tensor, k_rot_new: torch.Tensor, pos: CachePosition) -> None:
        """Quantize ``latent_new (b, s, r)`` and ``k_rot_new (b, s, dr)`` and
        store them at positions ``[pos, pos + s)`` (``pos`` an int or a
        ``(b,)`` tensor on the cache's device)."""
        r = latent_new.shape[-1]
        if self.layout == "dmajor":
            if not isinstance(pos, torch.Tensor):  # an int start: a device tensor, no synchronisation
                b, s = latent_new.shape[:2]
                _check_int_position(pos, s, self.max_len)
                pos = torch.full((b,), pos, dtype=torch.int32, device=self.lat_data.device)
            mx_quantize_rows(latent_new.to(torch.bfloat16), k_rot_new.to(torch.bfloat16), self.elem_dtype_name,
                             out=self.buffers, pos=pos)
            return
        cat = torch.cat([latent_new.to(torch.bfloat16), k_rot_new.to(torch.bfloat16)], dim=-1).contiguous()
        s_all, d_all = quantize_mx(cat, self.elem_dtype_name, self.block_size)
        split = r // 2 if self.elem_dtype_name == "float4_e2m1" else r  # pair bytes split on pair boundaries
        nb = r // self.block_size
        _write_rows(self.lat_data, self._pack(d_all[..., :split]), pos)
        _write_rows(self.rot_data, self._pack(d_all[..., split:]), pos)
        _write_rows(self.lat_scale, s_all[..., :nb], pos)
        _write_rows(self.rot_scale, s_all[..., nb:], pos)

    def read(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dequantized ``(latent (b, L, r), k_rot (b, L, dr))`` bf16."""
        if self.layout == "dmajor":
            return tuple(dequantize_mx(d.transpose(1, 2), s.transpose(1, 2), self.elem_dtype_name, d.shape[1],
                                       torch.bfloat16, 2)
                         for d, s in ((self.lat_data, self.lat_scale), (self.rot_data, self.rot_scale)))
        return tuple(dequantize_mx(self._unpack(d), s, self.elem_dtype_name, self.block_size, torch.bfloat16, 2)
                     for d, s in ((self.lat_data, self.lat_scale), (self.rot_data, self.rot_scale)))


# -- multi-head latent attention --------------------------------------------------------------


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """Interleaved rope layout (x0 y0 x1 y1 ...) -> half-split (x... y...)."""
    b, h, s, d = x.shape
    return x.reshape(b, h, s, d // 2, 2).transpose(-1, -2).reshape(b, h, s, d)


def absorb(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bhsk,hkm->bhsm")`` of bf16 operands in float64, rounded once
    to bf16 (see the module docstring)."""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)[None]).to(torch.bfloat16)


class MLAAttention(nn.Module):
    """Multi-head latent attention (HF ``DeepseekV3Attention`` semantics), the
    absorbed cached form.  ``_project_inputs`` and ``_kv_b_halves`` are the
    seams the MX layer overrides (one activation quantize for the two
    projections of x there; the dequantized MX weight)."""

    def __init__(self, config: DeepseekV3Config, layer_idx: int = 0, device=None, generator=None):
        super().__init__()
        self.config, self.layer_idx = config, layer_idx
        h, n = config.hidden_size, config.num_attention_heads
        self.num_heads = n
        self.qk_nope_head_dim, self.qk_rope_head_dim = config.qk_nope_head_dim, config.qk_rope_head_dim
        self.v_head_dim, self.kv_lora_rank, self.qk_head_dim = config.v_head_dim, config.kv_lora_rank, config.qk_head_dim
        kw = dict(device=device, generator=generator)
        bias = config.attention_bias
        if config.q_lora_rank:
            self.q_a_proj = Linear(h, config.q_lora_rank, use_bias=bias, **kw)
            self.q_a_layernorm = RMSNorm(config.q_lora_rank, config.rms_norm_eps, device)
            self.q_b_proj = Linear(config.q_lora_rank, n * self.qk_head_dim, **kw)
        else:
            self.q_proj = Linear(h, n * self.qk_head_dim, **kw)
        self.kv_a_proj_with_mqa = Linear(h, self.kv_lora_rank + self.qk_rope_head_dim, use_bias=bias, **kw)
        self.kv_a_layernorm = RMSNorm(self.kv_lora_rank, config.rms_norm_eps, device)
        self.kv_b_proj = Linear(self.kv_lora_rank, n * (self.qk_nope_head_dim + self.v_head_dim), **kw)
        self.o_proj = Linear(n * self.v_head_dim, h, use_bias=bias, **kw)
        self.scaling = self.qk_head_dim ** -0.5

    def _project_inputs(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two projections of the layer's input: the query ``(b, s, n *
        qk_head_dim)`` and ``kv_a_proj_with_mqa``'s ``(b, s, r + dr)``."""
        if self.config.q_lora_rank:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        else:
            q = self.q_proj(x)
        return q, self.kv_a_proj_with_mqa(x)

    def _kv_b_halves(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``kv_b_proj``'s K half ``(n, dn, r)`` and V half ``(n, dv, r)``."""
        n, dn = self.num_heads, self.qk_nope_head_dim
        w = self.kv_b_proj.weight.reshape(n, dn + self.v_head_dim, self.kv_lora_rank)
        return w[:, :dn], w[:, dn:]

    def forward(self, hidden, *, cos, sin, cache, cache_position: CachePosition):
        b, s, _ = hidden.shape
        n, dn, dr, r = self.num_heads, self.qk_nope_head_dim, self.qk_rope_head_dim, self.kv_lora_rank
        q, ckv = self._project_inputs(hidden)
        q = q.view(b, s, n, self.qk_head_dim).transpose(1, 2)
        q_pass, q_rot = q[..., :dn], q[..., dn:]
        latent = self.kv_a_layernorm(ckv[..., :r])
        k_rot = ckv[..., r:].reshape(b, 1, s, dr)
        if self.config.rope_interleave:
            q_rot, k_rot = _deinterleave(q_rot), _deinterleave(k_rot)
        q_rot, k_rot = apply_rotary_pos_emb(q_rot, k_rot, cos, sin)
        cache.write(latent, k_rot[:, 0], cache_position)
        wk, wv = self._kv_b_halves()
        q_lat = absorb(q_pass, wk)  # (b, n, s, r)
        out_lat = mla_cached_attention(q_lat, q_rot, cache, cache_position, cache_position + s, self.scaling)
        out = absorb(out_lat, wv.transpose(1, 2))  # (b, n, s, dv)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, n * self.v_head_dim))


# -- the noaux-tc routed MoE ------------------------------------------------------------------


def _top(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, the lower index first among equal
    values (as ``jax.lax.top_k``: a stable descending sort)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def noaux_choice(scores: torch.Tensor, bias: torch.Tensor, config: DeepseekV3Config) -> torch.Tensor:
    """The values experts are chosen by: ``scores + bias``, with the experts
    of every group outside the ``topk_group`` best (by the sum of a group's
    two best values) set to 0."""
    choice = scores + bias.to(torch.float32)[None, :]
    T, E = choice.shape
    G = config.n_group
    if G > 1:
        sub = E // G
        g_scores = _top(choice.reshape(T, G, sub), min(2, sub))[0].sum(-1)
        g_idx = _top(g_scores, config.topk_group)[1]
        g_mask = torch.zeros((T, G), dtype=torch.bool, device=choice.device).scatter(1, g_idx, True)
        choice = torch.where(g_mask.repeat_interleave(sub, dim=1), choice, 0.0)
    return choice


def route_noaux_tc(scores: torch.Tensor, bias: torch.Tensor, config: DeepseekV3Config):
    """``(top_w (T, k) f32, top_idx (T, k) int32)`` from the sigmoid scores
    ``(T, E)``: the experts by ``noaux_choice``, their weights gathered from
    the raw scores, renormalised (``+ 1e-20``) when ``norm_topk_prob``, times
    ``routed_scaling_factor``."""
    top_idx = _top(noaux_choice(scores, bias, config), config.num_experts_per_tok)[1]
    top_w = scores.gather(1, top_idx)
    if config.norm_topk_prob:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    return top_w * config.routed_scaling_factor, top_idx.to(torch.int32)


class DeepseekV3MoE(MixtralSparseMoeBlock):
    """The Mixtral block (experts of ``moe_intermediate_size``) with the
    noaux-tc router and the shared experts.  The correction bias is the
    router's f32 ``gate.e_score_correction_bias`` (HF's buffer name)."""

    def __init__(self, config: DeepseekV3Config, device=None, generator=None):
        super().__init__(dataclasses.replace(config, intermediate_size=config.moe_intermediate_size), device,
                         generator)
        self.gate.e_score_correction_bias = nn.Parameter(
            torch.zeros(config.n_routed_experts, dtype=torch.float32, device=device), requires_grad=False)
        self.shared_experts = LlamaMLP(
            dataclasses.replace(config, intermediate_size=config.moe_intermediate_size * config.n_shared_experts),
            device, generator)

    def _route_raw(self, x_t: torch.Tensor):
        scores = torch.sigmoid(cuda_moe.mx_router_logits(x_t.to(torch.bfloat16), self.gate.weight, f32=True))
        return route_noaux_tc(scores, self.gate.e_score_correction_bias, self.config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return MixtralSparseMoeBlock.forward(self, x) + self.shared_experts(x)


# -- decoder, model, LM ---------------------------------------------------------------------------


class DeepseekV3DecoderLayer(LlamaDecoderLayer):
    """MLA attention; a dense MLP below ``first_k_dense_replace``, the MoE
    from there on."""

    def __init__(self, config: DeepseekV3Config, layer_idx: int, device=None, generator=None):
        nn.Module.__init__(self)
        self.self_attn = MLAAttention(config, layer_idx, device, generator)
        dense = layer_idx < config.first_k_dense_replace
        self.mlp = (LlamaMLP if dense else DeepseekV3MoE)(config, device, generator)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)


class DeepseekV3Model(LlamaModel):
    layer_cls = DeepseekV3DecoderLayer


class DeepseekV3ForCausalLM(LlamaForCausalLM):
    model_cls = DeepseekV3Model

    def init_cache(self, batch: int, max_len: int, kv_cache_config=None) -> List:
        """Per-layer latent caches: ``MLACache`` (bf16) for ``None``, else an
        ``MXMLACache`` of the config's format."""
        c = self.config
        if kv_cache_config is None:
            return [MLACache.create(batch, max_len, c.kv_lora_rank, c.qk_rope_head_dim, self.device)
                    for _ in range(c.num_hidden_layers)]
        return [MXMLACache.create(batch, max_len, c.kv_lora_rank, c.qk_rope_head_dim,
                                  kv_cache_config.elem_dtype_name, kv_cache_config.block_size, device=self.device)
                for _ in range(c.num_hidden_layers)]

