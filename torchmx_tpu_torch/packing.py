"""fp4 payload packing: two 4-bit codes per byte, first element in the HIGH
nibble (``b = e0 << 4 | e1``), the layout of ``torchmx_tpu/packing.py``."""

from __future__ import annotations

import torch


def pack_uint4(codes: torch.Tensor, packing_dim: int = -1) -> torch.Tensor:
    """Pack pairs of uint4 codes (one per byte) along ``packing_dim``."""
    dim = packing_dim % codes.dim()
    n = codes.shape[dim]
    if n % 2:
        raise ValueError(f"pack_uint4 needs an even length along dim {dim}, got {n}")
    pairs = codes.unflatten(dim, (n // 2, 2))
    hi = pairs.select(dim + 1, 0)
    lo = pairs.select(dim + 1, 1)
    return ((hi << 4) | (lo & 0xF)).to(torch.uint8)


def unpack_uint4(packed: torch.Tensor, packing_dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_uint4`: one uint4 code per byte."""
    dim = packing_dim % packed.dim()
    both = torch.stack([packed >> 4, packed & 0xF], dim=dim + 1)
    return both.flatten(dim, dim + 1).to(torch.uint8)


def fp4_pairs_to_halves(packed: torch.Tensor) -> torch.Tensor:
    """Pair-packed fp4 bytes along the last dim (the quantizer's output) to
    the d-halves packing of an fp4 KV cache: byte ``p`` holds element ``p``
    in its high nibble and element ``p + d/2`` in its low nibble."""
    u = unpack_uint4(packed, packing_dim=-1)
    half = u.shape[-1] // 2
    return (u[..., :half] << 4) | (u[..., half:] & 0xF)


def fp4_halves_to_pairs(data: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fp4_pairs_to_halves`."""
    return pack_uint4(torch.cat([data >> 4, data & 0xF], dim=-1), packing_dim=-1)
