"""K4 ``mx_cached_attention``: the CUDA kernel (``csrc/mx_attention.cu``), its
plain PyTorch version, and ``cached_attention_any``, the dispatch the Llama
attention calls (``torchmx_tpu/ops/pallas_attention.py:906-1019``, seq
layout, no window, ring or softcap in this port).

Semantics of both versions: scores ``s = (q . k) * sm_scale`` in fp32 over
the dequantized cache; query row ``i`` of batch row ``b`` sees key positions
``<= q_off[b] + i`` and ``< kv_len[b]``; masked scores are ``-1e30``;
softmax in fp32 with ``p`` rounded to bf16 before the P.V product; a row
with no visible key outputs 0.  Both versions are the online (flash) form
over tiles of 64 positions; they differ only in fp32 summation order.
"""

from __future__ import annotations

from typing import Union

import torch

from ..mx_array import dequantize_mx
from . import cuda_lib
from .backend import on_cuda

NEG_INF = -1e30
KV_TILE = 64  # KV positions per online-softmax step (kL in csrc/mx_attention.cu)
IntOrTensor = Union[int, torch.Tensor]


def _per_row(v: IntOrTensor, b: int, device) -> torch.Tensor:
    """(b,) int32 on ``device``.  An int is filled in on the device: copying
    it from the host would synchronise the stream at every call."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(v), dtype=torch.int32, device=device)


def mx_cached_attention_plain(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, elem_dtype_name: str,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of K4: the same online softmax over the dequantized
    cache, tile by tile (``KV_TILE`` positions), with ``p`` rounded to bf16
    against the running max as the kernel does; only fp32 summation orders
    differ from the kernel.  ``compute_dtype=torch.float64`` computes the
    same function with another rounding, to measure sensitivity to it."""
    if elem_dtype_name == "float4_e2m1":
        raise NotImplementedError("fp4 KV caches (d-halves packing) are not ported yet")
    b, hq, sq, d = q.shape
    hkv, L = k_data.shape[1], k_data.shape[2]
    G = hq // hkv
    k = dequantize_mx(k_data, k_scale, elem_dtype_name, 32, torch.bfloat16, 3)
    v = dequantize_mx(v_data, v_scale, elem_dtype_name, 32, torch.bfloat16, 3)
    f = compute_dtype
    k = k.to(f).repeat_interleave(G, dim=1)
    v = v.to(f).repeat_interleave(G, dim=1)
    qf = q.to(f)
    q_off = _per_row(q_off, b, q.device)
    kv_len = _per_row(kv_len, b, q.device)
    q_pos = (q_off[:, None] + torch.arange(sq, device=q.device)[None, :])[:, None, :, None]
    m = torch.full((b, hq, sq, 1), NEG_INF, dtype=f, device=q.device)
    l = torch.zeros((b, hq, sq, 1), dtype=f, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=f, device=q.device)
    for t0 in range(0, min(L, int(kv_len.max())), KV_TILE):
        kv_pos = torch.arange(t0, min(t0 + KV_TILE, L), device=q.device)
        s = (qf @ k[:, :, t0:t0 + KV_TILE].transpose(-1, -2)) * sm_scale
        valid = (kv_pos <= q_pos) & (kv_pos < kv_len[:, None, None, None])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).to(f) @ v[:, :, t0:t0 + KV_TILE]
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(torch.bfloat16)


def mx_cached_attention(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, elem_dtype_name: str
) -> torch.Tensor:
    """K4: ``q (b, hq, sq, d)`` bf16 over the seq-layout MX cache
    ``(b, hkv, L, d)`` codes + ``(b, hkv, L, d/32)`` scales.  CUDA tensors
    launch the kernel (fp8 cache, d = 128, L % 64 == 0; other shapes raise)."""
    if not on_cuda(q, k_data, k_scale, v_data, v_scale):
        return mx_cached_attention_plain(
            q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale, elem_dtype_name
        )
    b, hq, sq, d = q.shape
    _, hkv, L, dp = k_data.shape
    if elem_dtype_name != "float8_e4m3" or d != 128 or dp != d or L % 64 or hq % hkv:
        raise ValueError(
            f"the attention kernel takes an fp8 cache with d=128 and L % 64 == 0, "
            f"got {elem_dtype_name} q{tuple(q.shape)} cache{tuple(k_data.shape)}"
        )
    for t in (k_data, k_scale, v_data, v_scale):
        if not t.is_contiguous() or t.dtype != torch.uint8:
            raise ValueError("cache codes and scales must be contiguous uint8")
    q = q.to(torch.bfloat16).contiguous()
    q_off = _per_row(q_off, b, q.device)
    kv_len = _per_row(kv_len, b, q.device)
    out = torch.empty_like(q)
    cuda_lib.launch(
        "mx_attention", "mx_cached_attention_launch",
        q.data_ptr(), k_data.data_ptr(), k_scale.data_ptr(), v_data.data_ptr(),
        v_scale.data_ptr(), q_off.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, L, d, float(sm_scale), cuda_lib.ELEM_CODES[elem_dtype_name],
    )
    return out


def cached_attention_any(q, cache, q_off: IntOrTensor, kv_len: IntOrTensor, sm_scale: float):
    """Causal attention of ``q (b, hq, sq, d)`` (RoPE applied) over an
    ``MXLayerKVCache`` holding the cache after the current tokens were
    written; ``q_off`` is the first query position and ``kv_len`` the
    visible prefix, each an int or a (b,) tensor."""
    if cache.block_size != 32:
        raise ValueError("MX KV caches use block size 32")
    return mx_cached_attention(
        q, cache.k_data, cache.k_scale, cache.v_data, cache.v_scale,
        q_off, kv_len, sm_scale, cache.elem_dtype_name,
    )
