"""Mixtral (``torchmx_tpu/models/mixtral.py``): Mistral attention and a sparse
Mixture-of-Experts MLP with stacked expert weights.

The expert weights are stored K-major, as in the JAX package: ``w1`` (gate)
and ``w3`` (up) are ``(E, H, I)``, ``w2`` (down) is ``(E, I, H)``; the
router ``gate`` is a plain ``Linear`` (torch layout ``(E, H)``).  Routing is
HF Mixtral's: an fp32 softmax over all experts, the top k, renormalized.
Among equal probabilities the lower expert index wins, as ``jax.lax.top_k``
picks it (a stable descending sort; ``torch.topk`` promises no order among
ties).

Three modes, as in the JAX package:

* ``capacity_factor`` None, ``grouped`` False (default): exact routing, every
  expert on every token, masked by the combine weights;
* ``capacity_factor`` f: dispatch / combine with per-expert capacity
  ``ceil(f * k * T / E)``, overflow tokens dropped and the combine weights
  renormalized over the surviving experts;
* ``grouped``: the dropless grouped GEMM (``ops/moe.py``, B12 on the card).

The expert SwiGLU runs ``silu`` in f32 and rounds the product once to bf16
(not the bf16 ``silu`` of ``LlamaMLP``).  ``_router_logits``,
``_expert_ffn_all`` / ``_batched`` / ``_grouped`` and ``_route_raw`` are the
seams the MX blocks (``layers/mx_mixtral_moe.py``) override.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..layers.linear import Linear
from ..ops import cuda_moe, moe
from .llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaModel
from .mistral import MistralAttention, MistralConfig


@dataclasses.dataclass
class MixtralConfig(MistralConfig):
    sliding_window: Optional[int] = None  # v0.1 trained at 4096 but serves the full prefix
    num_local_experts: int = 8
    num_experts_per_tok: int = 2


def route_topk_raw(router_logits: torch.Tensor, k: int):
    """``(top_vals (T, k) f32, top_idx (T, k) int32)``: fp32 softmax over all
    experts, the k largest (lower index first among equal values),
    renormalized."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :k], idx[:, :k]
    return top_vals / top_vals.sum(dim=-1, keepdim=True), top_idx.to(torch.int32)


def dense_combine_weights(top_vals: torch.Tensor, top_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Sparse routing (T, k) -> dense combine weights (T, E), 0 for the
    experts not selected."""
    cw = torch.zeros((top_vals.shape[0], num_experts), dtype=top_vals.dtype, device=top_vals.device)
    return cw.scatter(1, top_idx.to(torch.int64), top_vals)


def route_topk(router_logits: torch.Tensor, k: int) -> torch.Tensor:
    """Dense form of :func:`route_topk_raw`: combine weights (T, E)."""
    top_vals, top_idx = route_topk_raw(router_logits, k)
    return dense_combine_weights(top_vals, top_idx, router_logits.shape[-1])


def router_logits(x_t: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The high-precision router of the MX blocks, ``x_t @ W.T`` with an f32
    accumulation and one bf16 rounding (``weight``: (E, H), torch layout):
    on the card a row-wise kernel, so that a token's logits do not depend on
    the other tokens (``ops/cuda_moe.mx_router_logits``)."""
    return cuda_moe.mx_router_logits(x_t, weight)


def swiglu_f32(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    """``silu(h1) * h3`` in f32, rounded once to bf16 (the experts' SwiGLU)."""
    h1 = h1.to(torch.float32)
    return (h1 * torch.sigmoid(h1) * h3.to(torch.float32)).to(torch.bfloat16)


def combine_dense(cw: torch.Tensor, y_all: torch.Tensor) -> torch.Tensor:
    """``einsum("te,eth->th")`` in f32, adding the experts' weighted outputs
    one product at a time in expert order: a token's two selected terms then
    round exactly as in ``moe.combine_tokens`` (the others are zeros)."""
    y = torch.zeros(y_all.shape[1:], dtype=torch.float32, device=y_all.device)
    for e in range(y_all.shape[0]):
        y = y + cw[:, e, None] * y_all[e].to(torch.float32)
    return y


class MixtralSparseMoeBlock(nn.Module):
    """Sparse MoE MLP with stacked expert weights (see the module docstring).
    With a generator the weights are normal with std 1/sqrt(H), made one
    expert matrix at a time; else zeros."""

    def __init__(self, config: MixtralConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        h, i, e = config.hidden_size, config.intermediate_size, config.num_local_experts
        self.gate = Linear(h, e, device=device, generator=generator)
        std = 1.0 / math.sqrt(h)
        for name, shape in (("w1", (h, i)), ("w3", (h, i)), ("w2", (i, h))):
            w = torch.zeros((e, *shape), dtype=torch.bfloat16, device=device)
            if generator is not None:
                for j in range(e):
                    w[j] = torch.randn(shape, generator=generator, device=device) * std
            setattr(self, name, nn.Parameter(w, requires_grad=False))
        # None: exact dense-masked routing; a float: dispatch / combine with
        # capacity ceil(f * k * T / E).
        self.capacity_factor: Optional[float] = None
        # True: the dropless grouped GEMM; takes precedence over capacity_factor.
        self.grouped: bool = False
        self.grouped_tm: int = 128  # row tile of the grouped GEMM

    # -- seams the MX blocks override -------------------------------------------
    def _router_logits(self, x_t: torch.Tensor) -> torch.Tensor:
        return self.gate(x_t)

    def _expert_ffn_all(self, x_t: torch.Tensor) -> torch.Tensor:
        """(T, H) tokens -> (E, T, H): every expert's SwiGLU output."""
        xf = x_t.to(torch.float32)
        act = swiglu_f32(xf @ self.w1.to(torch.float32), xf @ self.w3.to(torch.float32))
        return (act.to(torch.float32) @ self.w2.to(torch.float32)).to(x_t.dtype)

    def _expert_ffn_batched(self, xe: torch.Tensor) -> torch.Tensor:
        """(E, C, H) dispatched tokens -> (E, C, H)."""
        xf = xe.to(torch.float32)
        act = swiglu_f32(torch.bmm(xf, self.w1.to(torch.float32)), torch.bmm(xf, self.w3.to(torch.float32)))
        return torch.bmm(act.to(torch.float32), self.w2.to(torch.float32)).to(xe.dtype)

    def _expert_ffn_grouped(self, x_sorted, tile_expert, tile_rows, tm: int, **bounds) -> torch.Tensor:
        """(R, H) expert-sorted padded rows -> (R, H) through the grouped
        GEMM (bf16 experts); ``bounds``: ``moe.row_bounds``."""
        h1 = moe.grouped_matmul(x_sorted, self.w1, tile_expert, tile_rows, tm=tm, **bounds)
        h3 = moe.grouped_matmul(x_sorted, self.w3, tile_expert, tile_rows, tm=tm, **bounds)
        return moe.grouped_matmul(swiglu_f32(h1, h3), self.w2, tile_expert, tile_rows, tm=tm, **bounds)

    def _route_raw(self, x_t: torch.Tensor):
        """Routing seam: ``(top_vals (T, k) f32, top_idx (T, k) int32)``."""
        return route_topk_raw(self._router_logits(x_t), self.config.num_experts_per_tok)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        x_t = x.reshape(b * s, h)
        top_vals, top_idx = self._route_raw(x_t)
        if self.grouped:
            tm = self.grouped_tm
            E = self.config.num_local_experts
            x_sorted, tile_expert, tile_rows, dest = moe.group_tokens(x_t, top_idx, tm, E)
            bounds = moe.row_bounds(x_t.shape[0], top_idx.shape[1], E)
            y_sorted = self._expert_ffn_grouped(x_sorted, tile_expert, tile_rows, tm, **bounds)
            y = moe.combine_tokens(y_sorted, dest, top_vals)
        else:
            cw = dense_combine_weights(top_vals, top_idx, self.config.num_local_experts)
            if self.capacity_factor is None:
                y = combine_dense(cw, self._expert_ffn_all(x_t))
            else:
                y = self._dispatch_combine(x_t, cw)
        return y.to(x.dtype).reshape(b, s, h)

    def _dispatch_combine(self, x_t: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
        """Capacity-bounded dispatch / combine: one-hot matrices, overflow
        dropped, the combine weights renormalized over the kept experts so
        that a token keeps its total routed weight."""
        T, _ = x_t.shape
        e, k = self.config.num_local_experts, self.config.num_experts_per_tok
        C = min(max(1, int(math.ceil(self.capacity_factor * k * T / e))), T)
        sel = cw > 0
        pos_in_e = torch.cumsum(sel.to(torch.int32), dim=0) - 1  # arrival order in each queue
        keep = sel & (pos_in_e < C)
        disp = keep[:, :, None] & (pos_in_e[:, :, None] == torch.arange(C, device=x_t.device))
        dispf = disp.to(x_t.dtype)  # (T, E, C)
        xe = torch.einsum("tec,th->ech", dispf.to(torch.float32), x_t.to(torch.float32)).to(x_t.dtype)
        ye = self._expert_ffn_batched(xe)
        cw_kept = torch.where(keep, cw, 0.0)
        full = cw.sum(dim=-1, keepdim=True)
        denom = cw_kept.sum(dim=-1, keepdim=True)
        cw_kept = torch.where(denom > 0, cw_kept * (full / denom), 0.0)
        comb = dispf * cw_kept.to(x_t.dtype)[:, :, None]
        return torch.einsum("tec,ech->th", comb.to(torch.float32), ye.to(torch.float32))


class MixtralDecoderLayer(LlamaDecoderLayer):
    attention_cls = MistralAttention
    mlp_cls = MixtralSparseMoeBlock

    @property
    def block_sparse_moe(self):
        """The checkpoint's name of the MoE block."""
        return self.mlp


class MixtralModel(LlamaModel):
    layer_cls = MixtralDecoderLayer


class MixtralForCausalLM(LlamaForCausalLM):
    model_cls = MixtralModel
