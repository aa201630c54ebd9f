"""The combine buffers of the kernels that split the KV length across the
card and combine the chunks in the same launch: B13 (``ops/cuda_mla.
mx_mla_attention``), K7 (``ops/cuda_attention.mx_cached_attention_int8dot``,
whose chunks are JAX's KV tiles) and B14 (``ops/cuda_mla.
mx_mla_attention_int8dot``).

Each live chunk of a query tile with two or more writes its rows' fp32
partials to a workspace; the tile's last CTA, known by an atomic ticket that
it resets, combines them.  The kernels share one workspace and one ticket
array per device (launches on one stream do not overlap), grown on demand
and never shrunk: the kernels leave the tickets at zero, so no call
allocates or clears anything once they are large enough, and a fixed-shape
step can size them before it runs (``scratch``).  A call whose workspace
would pass a kernel's cap runs one launch per group of rows that fits
(``launch_groups``); a row's bytes do not depend on the other rows of its
launch.
"""

from __future__ import annotations

import torch

#: per device: (workspace floats, tickets int32)
_SCRATCH: dict = {}


def scratch(dev: torch.device, ws_floats: int, n_tickets: int):
    """The device's workspace (at least ``ws_floats`` floats) and tickets (at
    least ``n_tickets`` ints, zero), grown where they are smaller."""
    ws, tickets = _SCRATCH.get(dev, (None, None))
    if ws is None or ws.numel() < ws_floats:
        ws = torch.empty(max(ws_floats, 1), dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1), dtype=torch.int32, device=dev)
    _SCRATCH[dev] = (ws, tickets)
    return ws, tickets


def held_bytes() -> int:
    """The bytes the combine buffers hold on every device."""
    return sum(t.numel() * t.element_size() for pair in _SCRATCH.values() for t in pair)


def launch_groups(b: int, rows: int, unit: int, row_floats: int, cap_bytes: int) -> list:
    """A call's launches: ``(first batch row, end, first row, end)`` each.
    ``row_floats`` is the workspace a (batch row, row) may need (0 where the
    grid has one chunk: no tile then writes a partial).  One launch where the
    call's workspace fits ``cap_bytes``; else groups of batch rows that fit,
    or, where one batch row does not, groups of its rows, a multiple of
    ``unit`` (so that each group starts at a query position)."""
    cap = cap_bytes // 4
    if b * rows * row_floats <= cap:
        return [(0, b, 0, rows)]

    def even(total: int, most: int) -> int:  # the size of ceil(total / most) groups of about equal size
        return -(-total // -(-total // most))

    if rows * row_floats <= cap:
        gb = even(b, cap // (rows * row_floats))
        return [(i, min(b, i + gb), 0, rows) for i in range(0, b, gb)]
    gr = unit * even(rows // unit, max(1, cap // row_floats // unit))
    return [(i, i + 1, r0, min(rows, r0 + gr)) for i in range(b) for r0 in range(0, rows, gr)]
