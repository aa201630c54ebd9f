"""Dropless grouped Mixture-of-Experts around the grouped GEMM: the host side
of ``torchmx_tpu/ops/pallas_moe.py`` (``plan_group_layout``,
``group_tokens``, ``combine_tokens``) and ``grouped_matmul``, which runs B12
on CUDA tensors and its plain version on CPU tensors
(``ops/cuda_moe.py``).

The (token, expert) assignments are sorted by expert (a stable sort) and
each expert's group is padded to a multiple of the row tile ``tm``, so a row
tile never holds two experts; the padded row count ``R`` depends on (T, k,
E, tm) alone and is computed on the host.  Everything else stays on the
device: ``group_tokens`` reads nothing back, so a layer does not
synchronise with the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_moe


def plan_group_layout(T: int, k: int, E: int, tm: int) -> int:
    """Static padded row count: every expert group padded to a ``tm``
    multiple never exceeds ceil(A/tm)+E full tiles (A = T*k)."""
    A = T * k
    return ((A + tm - 1) // tm + E) * tm


def group_tokens(x_t: torch.Tensor, top_idx: torch.Tensor, tm: int,
                 num_experts: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort the (token, expert) assignments by expert, pad each group to a
    ``tm`` multiple and gather the token rows into the padded layout.

    ``x_t`` (T, H) tokens, ``top_idx`` (T, k) expert ids.  Returns
    ``(x_sorted (R, H), tile_expert (R/tm,), tile_rows (R/tm,), dest
    (T*k,))`` (int32 indices): ``dest`` maps assignment ``a = t*k + i`` to
    its row; ``tile_rows`` counts each tile's live rows; trailing dead tiles
    carry the last live tile's expert."""
    T, k = top_idx.shape
    E, dev = num_experts, x_t.device
    A = T * k
    R = plan_group_layout(T, k, E, tm)
    expert_of_a = top_idx.reshape(A).to(torch.int64)
    token_of_a = torch.arange(T, device=dev).repeat_interleave(k)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(0, expert_of_a, torch.ones_like(expert_of_a))
    padded = (counts + tm - 1) // tm * tm
    group_end = torch.cumsum(padded, 0)
    group_start = group_end - padded
    # Rank of each assignment within its expert's group (arrival order), by
    # one stable sort: position in the sorted order minus its run's start.
    sorted_e, order = torch.sort(expert_of_a, stable=True)
    run_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.empty(A, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(A, device=dev) - run_start[sorted_e]
    dest = group_start[expert_of_a] + rank
    x_sorted = torch.zeros((R, x_t.shape[1]), dtype=x_t.dtype, device=dev)
    x_sorted[dest] = x_t[token_of_a]
    # Tile t's expert owns the padded span holding the tile's first row;
    # dead tiles past every group take the last live tile's expert.
    tile_starts = torch.arange(R // tm, device=dev) * tm
    total = group_end[-1:]
    te_raw = torch.searchsorted(group_end, tile_starts, right=True).clamp(max=E - 1)
    te_last = torch.searchsorted(group_end, (total - 1).clamp(min=0), right=True).clamp(max=E - 1)
    tile_expert = torch.where(tile_starts < total, te_raw, te_last)
    tile_rows = (total - tile_starts).clamp(0, tm)
    return x_sorted, tile_expert.to(torch.int32), tile_rows.to(torch.int32), dest.to(torch.int32)


def combine_tokens(y_sorted: torch.Tensor, dest: torch.Tensor, top_vals: torch.Tensor) -> torch.Tensor:
    """Gather the per-assignment outputs back to token order and weight them
    by the routing weights, in f32, summed over k: (R, N) -> (T, N) f32."""
    T, k = top_vals.shape
    y_a = y_sorted[dest.to(torch.int64)].to(torch.float32) * top_vals.reshape(-1)[:, None]
    return y_a.reshape(T, k, -1).sum(dim=1)


def row_bounds(T: int, k: int, E: int) -> dict:
    """What the host knows of a grouped layout of ``T`` tokens routed to
    ``k`` experts each of ``E``: no expert holds more than ``T`` rows (a
    token's top-k experts are distinct), and at most ``min(E, T k)`` experts
    are live.  :func:`grouped_matmul`'s ``max_rows`` / ``max_experts``."""
    return dict(max_rows=max(T, 1), max_experts=min(E, max(T, 1) * k))


def grouped_matmul(x_sorted: torch.Tensor, w_stacked: torch.Tensor, tile_expert: torch.Tensor,
                   tile_rows: torch.Tensor, *, tm: int, w_scale: Optional[torch.Tensor] = None,
                   elem_name: Optional[str] = None, max_rows: Optional[int] = None,
                   max_experts: Optional[int] = None) -> torch.Tensor:
    """(R, K) expert-sorted rows x stacked (E, K, N) weights -> (R, N) bf16:
    row tile t contracts with expert ``tile_expert[t]``; ``w_scale`` /
    ``elem_name`` select the one-byte MX codes; ``max_rows`` /
    ``max_experts`` are :func:`row_bounds` (rows of a tile past ``max_rows``
    come out as 0).  B12 on CUDA tensors, its plain version on CPU
    tensors."""
    return cuda_moe.mx_grouped_matmul(x_sorted.contiguous(), w_stacked, tile_expert, tile_rows, tm,
                                      w_scale, elem_name, max_rows, max_experts)
