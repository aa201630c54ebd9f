"""fp4 payload packing: two 4-bit codes per byte, first element in the HIGH
nibble (``b = e0 << 4 | e1``), the layout of ``torchmx_tpu/packing.py``; and
the unpacking of the fp8 "halves" and fp6 "quarters" kernel layouts along
dim 0 (``MXTensor.to_fp8_halves`` / ``to_fp6_quarters`` pack them)."""

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


def fp8_halves_to_codes(words: torch.Tensor) -> torch.Tensor:
    """(K/2, N) uint16 words, word p holding the codes of rows p (high byte)
    and p + K/2 (low byte) -> (K, N) int32 codes."""
    w = words.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.cat([w >> 8, w & 0xFF], dim=0)


def fp6_quarters_to_codes(planes: torch.Tensor) -> torch.Tensor:
    """(3K/4, N) byte planes ``P0 = q0 << 2 | q3 >> 4``, ``P1 = q1 << 2 |
    (q3 >> 2) & 3``, ``P2 = q2 << 2 | q3 & 3`` -> (K, N) int32 fp6 codes, the
    K quarters q0..q3 in order."""
    q = planes.shape[0] // 3
    p0, p1, p2 = (planes[i * q:(i + 1) * q].to(torch.int32) for i in range(3))
    q3 = ((p0 & 3) << 4) | ((p1 & 3) << 2) | (p2 & 3)
    return torch.cat([p0 >> 2, p1 >> 2, p2 >> 2, q3], dim=0)
