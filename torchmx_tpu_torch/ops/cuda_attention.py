"""The attention kernels over an MX KV cache, their plain PyTorch versions,
and ``cached_attention_any``, the dispatch the Llama attention calls
(``torchmx_tpu/ops/pallas_attention.py:906-1019``; no window, ring or softcap
in this port):

* seq layout: K5 ``mx_cached_attention_chunkdot``
  (``csrc/mx_attention_chunkdot.cu``) for an int8 cache at one query
  position, K4 ``mx_cached_attention`` (``csrc/mx_attention.cu``) otherwise;
* d-major layout: K7 ``mx_cached_attention_int8dot``
  (``csrc/mx_attention_int8dot.cu``) for an int8 cache at one query position
  when ``TORCHMX_ATTN_INT8_DOT`` is ``"1"``, K6 ``mx_cached_attention_dmajor``
  (``csrc/mx_attention_dmajor.cu``) otherwise;
* no kernel where JAX's plan has none for the head_dim (``d % 128 != 0``,
  ``plan_cached_attention``): the dispatch returns None and the caller runs
  JAX's eager route, ``cached_attention_eager``.

Every query length at ``d % 128 == 0`` goes to K4 or K6, also where JAX's
``_pick_sqt`` finds no query tile and JAX's ``generate`` takes its eager
route (at a GQA group of 7, every sq > 36 that is not a multiple of 8): the
port follows the kernel, so that a row's bytes do not depend on how its
prompt was admitted (JAX's engine pads prompts to buckets and never meets
those lengths).

Semantics of K4 and K6, kernel and plain version alike, JAX's
``_attn_kernel``'s: scores ``s = (q . k) * sm_scale`` in fp32 over the
dequantized cache; query row ``i`` of batch row ``b`` sees key positions
``<= q_off[b] + i`` and ``< kv_len[b]``; masked scores are ``-1e30``; the
online softmax over JAX's KV tiles (``attention_tile(L)``: ``_pick_lt(L)``,
or the whole cache where none divides L), ``p`` rounded to bf16 against the
running maximum through each whole tile before the P.V product; a row with no
visible key outputs 0.  K6 reads the d-major cache (fp8, fp6, int8, and fp4
in the d-halves packing).  Both kernels are one cluster kernel
(``csrc/mx_attention_tile.cuh``) in the two layouts: a CTA a share of
``attention_share(L)`` positions, the shares' maxima exchanged across the
cluster before p is rounded, the shares combined in the same launch; it
differs from the plain version in fp32 summation order only, and K6 equals
K4 bit for bit on the same cache content.

K5 computes the same attention for ``sq == 1`` over an int8 cache with the
block scales factored out of the dots, p rounded to bf16 against JAX's running
maximum at JAX's tile (``mx_cached_attention_chunkdot_plain`` states the
formula and its rounding points); its kernel takes a share of a JAX tile a
CTA of a thread-block cluster, which exchanges the shares' maxima and
combines the shares in the same launch.  K7 goes further: q and p are
quantized to int8 too and both dots are exact integer sums, p requantized
once per KV tile of JAX's ``_pick_lt(L)`` positions
(``mx_cached_attention_int8dot_plain``); its kernel takes a tile a CTA,
quantizes q in its prologue and combines a row's tiles in the same launch
(``ops/split_kv``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from .. import env_variables as env
from ..mx_array import dequantize_mx, quantize_mx
from ..packing import fp4_halves_to_pairs
from . import cuda_lib, split_kv
from .backend import on_cuda

NEG_INF = -1e30
BLOCK = 32
IntOrTensor = Union[int, torch.Tensor]


def _pick_lt(L: int) -> Optional[int]:
    """JAX's KV tile for a cache of ``L`` positions
    (``torchmx_tpu/ops/pallas_attention.py:863-872``, also used by
    ``pallas_mla.py``): None where no tile divides L.  K5 rounds p against
    the running maximum through each such tile and K7 requantizes p once per
    tile; B14 and the MLA plan read it too (``ops/cuda_mla``)."""
    cap = 2048 if L >= 8192 else (1024 if L >= 2048 else 512)
    return next((c for c in (cap, 1024, 512, 256, 128) if c <= cap and L % c == 0), None)


K5_MAX_SHARES = 8  # CTAs of K5's cluster at most (kMaxCluster in csrc/mx_attention_chunkdot.cu)
K5_MAX_SHARE = 4096  # positions a CTA of K5 takes at most (kMaxShare): its scores fit shared memory


def attention_tile(L: int) -> int:
    """The KV tile of K4, K5 and K6 for a cache of ``L`` positions: JAX's
    ``_pick_lt(L)``, or the whole cache where no JAX tile divides L.  The
    dispatch sends K5 only lengths with a JAX tile (``use_chunkdot``);
    ``generate`` and the engine round their caches up to 128 positions, so no
    served path meets the other case, which JAX's plan serves by no kernel."""
    return _pick_lt(L) or L


def k5_share(L: int) -> int:
    """Positions a CTA of K5's kernel takes, a function of L alone, so that a
    row's arithmetic does not depend on the batch or the visible prefix.
    Where the cache holds more than ``K5_MAX_SHARES`` tiles (L = 1152 has 9
    of 128), whole consecutive tiles, the CTA walking their running maxima
    in order: at least 512 positions (the ragged decode over 1152 positions
    0.0394 ms a call at 512 against 0.0495 at 256 on an H100) and at most
    ``K5_MAX_SHARES`` shares.  Else a divisor of the tile: the tile itself where the cache is at most
    1024 positions (512 at L = 1024: the engine's decode), else the smallest
    share the cluster allows (1024 at L = 8192: more CTAs an SM, which the
    kernel's latency-bound loops need; ``tools/phase_profile.py --kernel
    k5``)."""
    lt = attention_tile(L)
    nt = L // lt
    if nt > K5_MAX_SHARES:
        return max(-(-nt // K5_MAX_SHARES), -(-512 // lt)) * lt
    return lt if L <= 1024 else lt // (K5_MAX_SHARES // nt)


def _per_row(v: IntOrTensor, b: int, device) -> torch.Tensor:
    """(b,) int32 on ``device``.  An int is filled in on the device: copying
    it from the host would synchronise the stream at every call."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(v), dtype=torch.int32, device=device)


K4_FORMATS = {"float8_e4m3": torch.uint8, "int8": torch.int8, "float6_e3m2": torch.uint8,
              "float6_e2m3": torch.uint8}  # format -> codes dtype


def _check_cache_tensors(k_data, k_scale, v_data, v_scale, codes_dtype) -> None:
    for t, dt in ((k_data, codes_dtype), (v_data, codes_dtype), (k_scale, torch.uint8), (v_scale, torch.uint8)):
        if not t.is_contiguous() or t.dtype != dt:
            raise ValueError(f"cache codes must be contiguous {codes_dtype} and scales contiguous uint8")


def dequantize_cache(data, scale, elem_dtype_name: str, layout: str = "seq") -> torch.Tensor:
    """One cache buffer pair, in either layout, to bf16 ``(b, kv, L, d)``."""
    if layout == "dmajor":
        data, scale = data.transpose(2, 3), scale.transpose(2, 3)
    if elem_dtype_name == "float4_e2m1":  # d-halves bytes -> the pair packing dequantize_mx reads
        data = fp4_halves_to_pairs(data)
    return dequantize_mx(data, scale, elem_dtype_name, 32, torch.bfloat16, 3)


def _online_attention(q, k, v, q_off, kv_len, sm_scale: float, compute_dtype: torch.dtype,
                      tile: Optional[int] = None) -> torch.Tensor:
    """The online softmax of K4 and K6 over a dequantized cache ``k, v (b, hkv,
    L, d)`` bf16, JAX's ``_attn_kernel`` form: KV tile by KV tile (``tile``
    positions, by default ``attention_tile(L)``: JAX's ``_pick_lt(L)``; the
    result depends on it), ``p`` rounded to bf16 against the running maximum
    through each tile."""
    b, hq, sq, d = q.shape
    hkv, L = k.shape[1], k.shape[2]
    tile = tile or attention_tile(L)
    G = hq // hkv
    f = compute_dtype
    q_off = _per_row(q_off, b, q.device)
    kv_len = _per_row(kv_len, b, q.device)
    # Positions at or past kv_len decode to 0, as in the kernels: a stale NaN
    # scale there must not reach the dots.
    live = (torch.arange(L, device=q.device) < kv_len[:, None])[:, None, :, None]
    k = torch.where(live, k, 0).to(f).repeat_interleave(G, dim=1)
    v = torch.where(live, v, 0).to(f).repeat_interleave(G, dim=1)
    qf = q.to(f)
    q_pos = (q_off[:, None] + torch.arange(sq, device=q.device)[None, :])[:, None, :, None]
    m = torch.full((b, hq, sq, 1), NEG_INF, dtype=f, device=q.device)
    l = torch.zeros((b, hq, sq, 1), dtype=f, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=f, device=q.device)
    for t0 in range(0, min(L, int(kv_len.max())), tile):
        kv_pos = torch.arange(t0, min(t0 + tile, L), device=q.device)
        s = (qf @ k[:, :, t0:t0 + tile].transpose(-1, -2)) * sm_scale
        valid = (kv_pos <= q_pos) & (kv_pos < kv_len[:, None, None, None])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)  # 0 too where a row sees no key at all
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).to(f) @ v[:, :, t0:t0 + tile]
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(torch.bfloat16)


def mx_cached_attention_plain(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, elem_dtype_name: str,
    compute_dtype: torch.dtype = torch.float32, tile: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K4: the online softmax over the dequantized seq-layout
    cache at JAX's tile (``_online_attention``; ``tile`` picks another).  It
    equals JAX's ``cached_attention_any`` bit for bit on the CPU at L = 256
    and 1024 but for fp32 summation order in rare elements (at most 0.1 % of
    them, each by less than one bf16 step of its row's largest); the kernel
    differs from it in fp32 summation order only.
    ``compute_dtype=torch.float64`` computes the same function with another
    rounding, to measure sensitivity to it."""
    if elem_dtype_name == "float4_e2m1":
        raise NotImplementedError("fp4 KV caches are ported in the d-major layout only")
    k = dequantize_cache(k_data, k_scale, elem_dtype_name)
    v = dequantize_cache(v_data, v_scale, elem_dtype_name)
    return _online_attention(q, k, v, q_off, kv_len, sm_scale, compute_dtype, tile)


ATTN_MAX_SHARES = 8  # CTAs of K4's and K6's cluster at most (kMaxCluster in csrc/mx_attention_tile.cuh)
ATTN_MAX_SHARE = 1 << 19  # positions a CTA takes at most (kMaxShare): its tiles' maxima fit shared memory
ATTN_CHUNK = 2048  # positions whose scores a 16-row tile holds at once (kMaxChunk); a longer share recomputes them
ATTN_WIDE_SHARE = 256  # the most for a 64-row tile, which holds all its scores (kWideShare)


def attention_share(L: int) -> int:
    """Positions a CTA of K4's and K6's cluster kernel takes, a function of L
    alone, so that a row's arithmetic depends on neither the batch, the query
    length nor the layout: the smallest power of two from 256 that cuts the
    cache into at most ``ATTN_MAX_SHARES`` shares (256 to L = 2048, 1024 at
    8192); a divisor of JAX's tile, or whole tiles where the cache holds
    more than 8 of them (L = 1152: shares of two tiles of 128).  256, not
    128: on an H100 the engine's ragged decode over 1024 positions took
    0.052 ms at 256 against 0.072 at 128, generate's decode over 256 0.020
    against 0.032 (``tools/phase_profile.py --kernel k4``).  Where no JAX tile
    divides L, the smallest multiple of 64 dividing L into at most 8 shares
    of the whole-cache tile."""
    if _pick_lt(L) is None:
        return next(P for P in range(64, L + 1, 64) if L % P == 0 and L // P <= ATTN_MAX_SHARES)
    P = 256
    while -(-L // P) > ATTN_MAX_SHARES:
        P *= 2
    return P


def attention_plan(L: int, rows: int) -> tuple:
    """``(tile, share, wide)`` of the cluster kernel for a cache of ``L``
    positions and ``rows`` query rows a KV head (sq * hq / hkv): 64-row
    tiles (``wide``) where a 64-row share's scores fit shared memory (L <=
    2048) and the rows fill more than 16, else 16-row tiles.  Raises where
    the kernel takes no such cache: L % 64 != 0, or a share past
    ``ATTN_MAX_SHARE`` positions (L > 4194304 = 2^22, 128 times the longest
    context of the port's models; a row keeps one maximum per JAX tile of its
    share in shared memory).  A share past ``ATTN_CHUNK`` positions (L >
    16384) is taken in chunks whose scores the kernel recomputes."""
    if L <= 0 or L % 64:
        raise ValueError(f"the attention kernels take caches of L % 64 == 0 positions, got L={L}")
    P = attention_share(L)
    if P > ATTN_MAX_SHARE:
        raise ValueError(f"the attention kernels take shares of at most {ATTN_MAX_SHARE} positions, so caches of "
                         f"L <= {ATTN_MAX_SHARE * ATTN_MAX_SHARES} positions, got L={L}")
    return attention_tile(L), P, rows > 16 and P <= ATTN_WIDE_SHARE


def _tile_attention(layout: str, q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float,
                    elem_dtype_name: str, fault: int) -> torch.Tensor:
    """One launch of the cluster kernel of K4 (``layout="seq"``) or K6
    (``"dmajor"``) on CUDA tensors, after the shape checks."""
    b, hq, sq, d = q.shape
    if layout == "seq":
        _, hkv, L, dp = k_data.shape
        formats, want_dp, scales = K4_FORMATS, d, (b, hkv, L, d // BLOCK)
    else:
        _, hkv, dp, L = k_data.shape
        formats, want_dp, scales = K6_FORMATS, d // 2 if elem_dtype_name == "float4_e2m1" else d, (b, hkv, d // BLOCK, L)
    if elem_dtype_name not in formats or d != 128 or dp != want_dp or hq % hkv:
        raise ValueError(f"the {layout} attention kernel takes a {'/'.join(formats)} cache with d=128, got "
                         f"{elem_dtype_name} q{tuple(q.shape)} cache{tuple(k_data.shape)}")
    lt, P, wide = attention_plan(L, sq * (hq // hkv))
    _check_cache_tensors(k_data, k_scale, v_data, v_scale, formats[elem_dtype_name])
    if k_scale.shape != scales or v_scale.shape != scales or v_data.shape != k_data.shape:
        raise ValueError(f"{layout} scales must be {scales} beside codes {tuple(k_data.shape)}")
    q = q.to(torch.bfloat16).contiguous()
    # Where kv_len is a number, no share past it is launched; a tensor is never read on the host.
    ctas = -(-L // P) if isinstance(kv_len, torch.Tensor) else max(1, -(-min(max(int(kv_len), 0), L) // P))
    _keep, pos = row_args(q_off, kv_len, b, q.device)
    out = torch.empty_like(q)
    src, fn = (("mx_attention", "mx_cached_attention_launch") if layout == "seq" else
               ("mx_attention_dmajor", "mx_cached_attention_dmajor_launch"))
    cuda_lib.launch(
        src, fn, q.data_ptr(), k_data.data_ptr(), k_scale.data_ptr(), v_data.data_ptr(), v_scale.data_ptr(),
        *pos, out.data_ptr(), b, hq, hkv, sq, L, d, lt, P, ctas, int(wide), float(sm_scale),
        cuda_lib.ELEM_CODES[elem_dtype_name], fault,
    )
    return out


def mx_cached_attention(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, elem_dtype_name: str,
    p_from_sub_tile_max: bool = False, drop_last_share: bool = False,
) -> torch.Tensor:
    """K4: ``q (b, hq, sq, d)`` bf16 over the seq-layout MX cache
    ``(b, hkv, L, d)`` codes (uint8, one code a byte; int8 for the int8
    format) + ``(b, hkv, L, d/32)`` scales.  CUDA tensors launch the cluster
    kernel (fp8, fp6 or int8 cache, d = 128, 16-byte aligned buffers, L and
    the share as ``attention_plan`` takes them: a multiple of 64, at most
    2^22; other shapes raise), one launch a call.  Where no JAX tile divides
    L the kernel takes the whole cache as its tile, as the plain version
    does.  ``q_off`` and ``kv_len`` are read on the device; where ``kv_len``
    is a number only the shares below it are launched.
    ``p_from_sub_tile_max`` (p rounded against the running maximum through
    its 64 positions, not through JAX's tile) and ``drop_last_share`` (the
    combine leaves out the last live share) are planted faults for the
    checks, never set by the package."""
    if not on_cuda(q, k_data, k_scale, v_data, v_scale):
        return mx_cached_attention_plain(
            q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale, elem_dtype_name
        )
    return _tile_attention("seq", q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale, elem_dtype_name,
                           int(p_from_sub_tile_max) | 2 * int(drop_last_share))


def _pow2_scale(se: torch.Tensor) -> torch.Tensor:
    """E8M0 exponents -> the fp32 whose bits are ``se << 23``: ``2^(se-127)``,
    and +0.0 for ``se == 0`` (a never-written slot)."""
    return (se.to(torch.int32) << 23).view(torch.float32)


def mx_cached_attention_chunkdot_plain(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float,
    compute_dtype: torch.dtype = torch.float32, tile: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K5, KV tile by KV tile (``tile`` positions, by default
    ``attention_tile(L)``: JAX's ``_pick_lt(L)``; the result depends on it), for the
    ``g = hq / hkv`` query rows r of each KV head, the ``d/32`` chunks c and
    position j:

    * ``s[r, j] = sm_scale * sum_c (q_c[r] . k_c[j]) * 2^(ek[j,c]-127)`` with
      ``k`` the bare int8 code, each chunk's partial sum in fp32 and the
      chunks added in chunk order;
    * j is visible when ``j <= q_off`` and ``j < kv_len``; masked scores are
      ``-1e30``;
    * JAX's online softmax over the tiles t in order: ``m_t = max(m_{t-1},
      max_j s)`` (``m_{-1} = -1e30``), ``p = exp(s - m_t)``, ``l_t = l_{t-1}
      e^(m_{t-1} - m_t) + sum_j p``;
    * ``acc_t[r, c] = acc_{t-1} e^(m_{t-1} - m_t) + sum_j bf16(p[r, j] *
      2^(ev[j,c]-127)) . v_c[j]``: the V scale folds into p, and the product
      is rounded to bf16 against the running maximum ``m_t`` before the dot;
      ``out = acc / l``;
    * a hidden position contributes nothing, whatever its stale scale holds;
      a row with no visible key outputs 0.

    At JAX's tile this is the JAX kernel's arithmetic, bit for bit on the CPU
    at L = 256 and 2048 (elsewhere within fp32 summation order).  The kernel
    rounds every p against the same ``m_t`` and combines the tiles at the
    end, so it differs in fp32 rounding only.  ``compute_dtype=torch.float64``
    computes the same function with another rounding, to measure
    sensitivity to it."""
    b, hq, sq, d = q.shape
    hkv, L = k_data.shape[1], k_data.shape[2]
    if sq != 1 or d % BLOCK or hq % hkv or k_data.dtype != torch.int8 or v_data.dtype != torch.int8:
        raise ValueError(f"chunk-dot attention takes sq == 1 over an int8 cache, got q{tuple(q.shape)} "
                         f"codes {k_data.dtype}")
    tile = tile or attention_tile(L)
    G, nc, f, dev = hq // hkv, d // BLOCK, compute_dtype, q.device
    qc = q.to(torch.bfloat16).to(f).reshape(b, hkv, G, nc, BLOCK)
    q_off = _per_row(q_off, b, dev)
    kv_len = _per_row(kv_len, b, dev)
    visible = torch.minimum(kv_len, q_off + 1).clamp(max=L)  # (b,) visible prefix
    m = torch.full((b, hkv, G, 1), NEG_INF, dtype=f, device=dev)
    l = torch.zeros((b, hkv, G, 1), dtype=f, device=dev)
    acc = torch.zeros((b, hkv, G, nc, BLOCK), dtype=f, device=dev)

    def codes_and_scales(data, scale, t0):
        codes = data[:, :, t0:t0 + tile].to(f)  # bare: int8 -> float is exact
        sc = _pow2_scale(scale[:, :, t0:t0 + tile]).to(f)
        # (b, hkv, T, nc, 32) codes and (b, hkv, 1, nc, T) scales
        return codes.reshape(b, hkv, -1, nc, BLOCK), sc.transpose(-1, -2)[:, :, None]

    for t0 in range(0, int(visible.max()), tile):
        kc, ksc = codes_and_scales(k_data, k_scale, t0)
        T = kc.shape[2]
        valid = (torch.arange(t0, t0 + T, device=dev) < visible[:, None])[:, None, None, :]
        dots = torch.einsum("bhgcd,bhjcd->bhgcj", qc, kc)  # chunk partial sums
        s = (dots * ksc).sum(dim=3) * sm_scale
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vc, vsc = codes_and_scales(v_data, v_scale, t0)
        # A hidden position contributes nothing, whatever its stale scale holds.
        p3 = torch.where(valid[:, :, :, None], (p[:, :, :, None] * vsc).to(torch.bfloat16).to(f), 0.0)
        acc = acc * alpha[..., None] + torch.einsum("bhgcj,bhjcd->bhgcd", p3, vc)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, 1, d).to(torch.bfloat16)


def row_args(q_off: IntOrTensor, kv_len: IntOrTensor, b: int, device):
    """``q_off`` and ``kv_len`` as K5 and B14 take them: ``(tensors to keep
    alive, (q_off pointer, kv_len pointer, q_off number, kv_len number))``.
    Two numbers go as they are, with null pointers (no fill launch); else
    both go as (b,) int32 on the device."""
    if not isinstance(q_off, torch.Tensor) and not isinstance(kv_len, torch.Tensor):
        return (), (None, None, int(q_off), int(kv_len))
    q_off, kv_len = _per_row(q_off, b, device), _per_row(kv_len, b, device)
    return (q_off, kv_len), (q_off.data_ptr(), kv_len.data_ptr(), 0, 0)


def mx_cached_attention_chunkdot(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float,
    p_from_own_tile_max: bool = False, drop_last_tile: bool = False, pad_stride: bool = False,
) -> torch.Tensor:
    """K5: ``q (b, hq, 1, d)`` bf16 over the seq-layout int8 MX cache
    ``(b, hkv, L, d)`` codes + ``(b, hkv, L, d/32)`` scales.  CUDA tensors
    launch the kernel (d = 128, hq / hkv from 1 to 8, L % 4 == 0, shares of
    ``k5_share(L) <= K5_MAX_SHARE`` positions, 16-byte aligned buffers; other
    shapes raise), one launch a call: a thread-block cluster a (batch row, KV
    head), a CTA a share (a part of a tile, or whole consecutive tiles), the
    shares' maxima shared across the cluster and the shares combined in the
    same launch.  ``q_off`` and ``kv_len`` are read on the device; where
    ``kv_len`` is a number only the shares below it are launched.
    ``p_from_own_tile_max`` (p rounded against its tile's own maximum, not
    the running one), ``drop_last_tile`` (a row's last live tile left out)
    and ``pad_stride`` (a group of 3, 5, 6 or 7 runs in the kernel built for
    4 or 8 rows: its query heads read at that stride) are planted faults for
    the checks, never set by the package."""
    if not on_cuda(q, k_data, k_scale, v_data, v_scale):
        return mx_cached_attention_chunkdot_plain(
            q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale
        )
    b, hq, sq, d = q.shape
    _, hkv, L, dp = k_data.shape
    lt, P = attention_tile(L), k5_share(L)
    if (sq != 1 or d != 128 or dp != d or hq % hkv or hq // hkv not in KERNEL_GROUPS or L % 4
            or P > K5_MAX_SHARE):
        raise ValueError(
            f"the chunk-dot attention kernel takes sq=1, d=128, hq/hkv in {KERNEL_GROUPS} and shares of "
            f"k5_share(L) <= {K5_MAX_SHARE} positions, got q{tuple(q.shape)} cache{tuple(k_data.shape)}"
        )
    _check_cache_tensors(k_data, k_scale, v_data, v_scale, torch.int8)
    if k_scale.shape != (b, hkv, L, d // BLOCK) or v_scale.shape != k_scale.shape or v_data.shape != k_data.shape:
        raise ValueError(f"seq scales must be ({b}, {hkv}, {L}, {d // BLOCK}) beside codes {tuple(k_data.shape)}")
    q = q.to(torch.bfloat16).contiguous()
    # Where kv_len is a number, no share past it is launched; a tensor is never read on the host.
    ctas = -(-L // P) if isinstance(kv_len, torch.Tensor) else max(1, -(-min(max(int(kv_len), 0), L) // P))
    _keep, pos = row_args(q_off, kv_len, b, q.device)
    out = torch.empty_like(q)
    cuda_lib.launch(
        "mx_attention_chunkdot", "mx_cached_attention_chunkdot_launch",
        q.data_ptr(), k_data.data_ptr(), k_scale.data_ptr(), v_data.data_ptr(), v_scale.data_ptr(),
        *pos, out.data_ptr(), b, hq, hkv, L, d, lt, P, ctas, float(sm_scale),
        int(p_from_own_tile_max) | 2 * int(drop_last_tile) | 4 * int(pad_stride),
    )
    return out


K6_FORMATS = {"float8_e4m3": torch.uint8, "int8": torch.int8, "float4_e2m1": torch.uint8,
              "float6_e3m2": torch.uint8, "float6_e2m3": torch.uint8}  # format -> codes dtype


def mx_cached_attention_dmajor_plain(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, elem_dtype_name: str,
    compute_dtype: torch.dtype = torch.float32, tile: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K6: K4's (``_online_attention`` at JAX's tile) over
    the dequantized d-major cache."""
    k = dequantize_cache(k_data, k_scale, elem_dtype_name, "dmajor")
    v = dequantize_cache(v_data, v_scale, elem_dtype_name, "dmajor")
    return _online_attention(q, k, v, q_off, kv_len, sm_scale, compute_dtype, tile)


def mx_cached_attention_dmajor(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, elem_dtype_name: str,
    p_from_sub_tile_max: bool = False, drop_last_share: bool = False,
) -> torch.Tensor:
    """K6: ``q (b, hq, sq, d)`` bf16 over the d-major MX cache ``(b, hkv, dp,
    L)`` codes (``dp = d``, or ``d/2`` for fp4 in the d-halves packing; int8
    for the int8 format, else uint8) + ``(b, hkv, d/32, L)`` scales.  CUDA
    tensors launch K4's cluster kernel in the d-major layout (d = 128,
    16-byte aligned cache buffers, L as ``attention_plan`` takes it; other
    shapes and buffers raise), one launch a call; on the same cache content
    it equals K4 bit for bit.  The planted faults are K4's."""
    if not on_cuda(q, k_data, k_scale, v_data, v_scale):
        return mx_cached_attention_dmajor_plain(
            q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale, elem_dtype_name
        )
    return _tile_attention("dmajor", q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale, elem_dtype_name,
                           int(p_from_sub_tile_max) | 2 * int(drop_last_share))


def _int8dot_check(q, k_data, v_data) -> None:
    b, hq, sq, d = q.shape
    if (sq != 1 or d % BLOCK or hq % k_data.shape[1] or k_data.shape[2] != d
            or k_data.dtype != torch.int8 or v_data.dtype != torch.int8):
        raise ValueError(f"int8-dot attention takes sq == 1 over an int8 d-major cache, got q{tuple(q.shape)} "
                         f"cache{tuple(k_data.shape)} codes {k_data.dtype}")


def quantize_q_int8(q: torch.Tensor, hkv: int):
    """K7's query: ``q (b, hq, 1, d)`` MXINT8-quantized per 32-block of
    head_dim, as ``(scales (b, hkv, g, d/32) uint8, codes (b, hkv, g, d)
    int8)``: the plain version's (K1 on a CUDA tensor); the kernel quantizes
    q in its prologue with K1's arithmetic, the same bits."""
    b, hq, _, d = q.shape
    return quantize_mx(q.to(torch.bfloat16).reshape(b, hkv, hq // hkv, d).contiguous(), "int8", BLOCK)


def mx_cached_attention_int8dot_plain(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, tile: Optional[int] = None
) -> torch.Tensor:
    """Plain version of K7, KV tile by KV tile (``tile`` positions, by default
    JAX's ``_pick_lt(L)``; the result depends on it), for the ``g = hq / hkv``
    query rows r of each KV head, the ``d/32`` chunks c and position j:

    * q is MXINT8-quantized per chunk (``quantize_q_int8``);
    * ``dots[c, r, j] = q_c[r] . k_c[j]``, an exact integer sum of int8
      products; ``s[r, j] = sm_scale * sum_c dots * 2^(eq[c,r]-127) *
      2^(ek[c,j]-127)``, each scale the fp32 whose bits are ``e << 23`` (0
      gives +0.0, 255 +inf);
    * j is visible when ``j <= q_off`` and ``j < kv_len``; masked scores are
      ``-1e30``; online softmax in fp32;
    * ``p3[c, r, j] = p[r, j] * 2^(ev[c,j]-127)``; per (chunk, row) and per
      tile ``mx = max_j p3`` (1 where 0) and ``pq = round_half_even(p3 *
      (127 / mx))`` as int8; ``pv[c, r] = pq . v_c``, exact; ``acc = acc *
      alpha + pv * (mx * (1 / 127))``;
    * a hidden position contributes nothing, whatever its stale scale holds;
      a row with no visible key outputs 0.

    At JAX's tile this is the JAX kernel's arithmetic, bit for bit on the
    CPU.  The kernel takes each tile's softmax against the tile's own
    maximum and combines the tiles at the end, so it differs in fp32
    rounding and in rare rounding ties of ``pq``.  The integer dots run in
    float64, where they are exact."""
    _int8dot_check(q, k_data, v_data)
    b, hq, _, d = q.shape
    hkv, L = k_data.shape[1], k_data.shape[3]
    tile = tile or _pick_lt(L)
    if tile is None:
        raise ValueError(f"int8-dot attention takes a cache length one of JAX's tiles divides (L % 128 == 0), got {L}")
    G, nc, dev, f64 = hq // hkv, d // BLOCK, q.device, torch.float64
    qs, qd = quantize_q_int8(q, hkv)
    qc = qd.reshape(b, hkv, G, nc, BLOCK).to(f64)
    q_scale = _pow2_scale(qs)[..., None]  # (b, hkv, G, nc, 1)
    q_off = _per_row(q_off, b, dev)
    kv_len = _per_row(kv_len, b, dev)
    visible = torch.minimum(kv_len, q_off + 1).clamp(max=L)  # (b,) visible prefix
    m = torch.full((b, hkv, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, G, nc, BLOCK), dtype=torch.float32, device=dev)
    for t0 in range(0, int(visible.max()), tile):
        kc = k_data[..., t0:t0 + tile].reshape(b, hkv, nc, BLOCK, -1).to(f64)
        T = kc.shape[-1]
        valid = (torch.arange(t0, t0 + T, device=dev) < visible[:, None])[:, None, None, :]  # (b, 1, 1, T)
        dots = torch.einsum("bhgcd,bhcdj->bhgcj", qc, kc).to(torch.float32)
        k_sc = _pow2_scale(k_scale[..., t0:t0 + tile])[:, :, None]  # (b, hkv, 1, nc, T)
        s = (dots * q_scale * k_sc).sum(dim=3) * sm_scale
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        v_sc = _pow2_scale(v_scale[..., t0:t0 + tile])[:, :, None]
        p3 = torch.where(valid[:, :, :, None], p[:, :, :, None] * v_sc, 0.0)  # (b, hkv, G, nc, T)
        mx = p3.amax(dim=-1, keepdim=True)
        mx = torch.where(mx == 0, 1.0, mx)
        pq = torch.round(p3 * (127.0 / mx))
        vc = v_data[..., t0:t0 + tile].reshape(b, hkv, nc, BLOCK, -1).to(f64)
        pv = torch.einsum("bhgcj,bhcdj->bhgcd", pq.to(f64), vc).to(torch.float32)
        acc = acc * alpha[..., None] + pv * (mx * (1.0 / 127.0))
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, 1, d).to(torch.bfloat16)


def mx_cached_attention_int8dot(
    q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale: float, drop_last_tile: bool = False,
    q_scale_from_next_chunk: bool = False, q_out: Optional[tuple] = None, pad_stride: bool = False,
    p_codes_down: bool = False,
) -> torch.Tensor:
    """K7: ``q (b, hq, 1, d)`` bf16 over the d-major int8 MX cache, both dots
    in int8.  CUDA tensors launch the kernel, which quantizes q itself (d =
    128, hq / hkv from 1 to 8, L % 128 == 0, 16-byte aligned cache buffers;
    other shapes raise), one launch a call, the tiles of JAX's ``_pick_lt(L)``
    split across the card and combined in the same launch; where ``kv_len`` is
    a number only the tiles below it are launched.  ``q_out``, a pair of
    tensors shaped as ``quantize_q_int8``'s result, receives the codes and
    scales the kernel computed for q (on the CPU, the plain quantizer's).
    ``drop_last_tile`` (the combine leaves out the last live tile of a row),
    ``q_scale_from_next_chunk`` (q's scale of chunk c taken from chunk c
    + 1), ``pad_stride`` (K5's) and ``p_codes_down`` (p's int8 codes rounded
    down, not to nearest) are planted faults for the checks, never set by the
    package."""
    if not on_cuda(q, k_data, k_scale, v_data, v_scale):
        if q_out is not None:
            for dst, src in zip(q_out, quantize_q_int8(q, k_data.shape[1])):
                dst.copy_(src)
        return mx_cached_attention_int8dot_plain(
            q, k_data, k_scale, v_data, v_scale, q_off, kv_len, sm_scale
        )
    _int8dot_check(q, k_data, v_data)
    b, hq, _, d = q.shape
    hkv, L = k_data.shape[1], k_data.shape[3]
    lt = _pick_lt(L)
    if d != 128 or hq // hkv not in KERNEL_GROUPS or lt is None:
        raise ValueError(
            f"the int8-dot attention kernel takes d=128, hq/hkv in {KERNEL_GROUPS} and L % 128 == 0, "
            f"got q{tuple(q.shape)} cache{tuple(k_data.shape)}"
        )
    _check_cache_tensors(k_data, k_scale, v_data, v_scale, torch.int8)
    if k_scale.shape != (b, hkv, d // BLOCK, L) or v_scale.shape != k_scale.shape or v_data.shape != k_data.shape:
        raise ValueError(f"d-major scales must be ({b}, {hkv}, {d // BLOCK}, {L}) beside codes {tuple(k_data.shape)}")
    q = q.to(torch.bfloat16).contiguous()
    # Where kv_len is a number, no tile past it is launched; a tensor is never read on the host.
    tiles = L // lt if isinstance(kv_len, torch.Tensor) else max(1, -(-min(int(kv_len), L) // lt))
    q_off = _per_row(q_off, b, q.device)
    kv_len = _per_row(kv_len, b, q.device)
    out = torch.empty_like(q)
    ws, tickets = split_kv.scratch(q.device, b * hq * tiles * (d + 2) if tiles > 1 else 0, b * hkv)
    qs_ptr = qd_ptr = None
    if q_out is not None:
        qs_out, qd_out = q_out
        if (qs_out.shape != (b, hkv, hq // hkv, d // BLOCK) or qs_out.dtype != torch.uint8 or qd_out.dtype != torch.int8
                or qd_out.shape != (b, hkv, hq // hkv, d) or not (qs_out.is_contiguous() and qd_out.is_contiguous())):
            raise ValueError("q_out must be contiguous (scales uint8, codes int8) shaped as quantize_q_int8's result")
        qs_ptr, qd_ptr = qs_out.data_ptr(), qd_out.data_ptr()
    cuda_lib.launch(
        "mx_attention_int8dot", "mx_cached_attention_int8dot_launch",
        q.data_ptr(), k_data.data_ptr(), k_scale.data_ptr(), v_data.data_ptr(), v_scale.data_ptr(),
        q_off.data_ptr(), kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), qd_ptr, qs_ptr,
        b, hq, hkv, L, d, lt, tiles, float(sm_scale),
        int(drop_last_tile) | 2 * int(q_scale_from_next_chunk) | 4 * int(pad_stride) | 8 * int(p_codes_down),
    )
    return out


# Query heads per KV head that K5 and K7 take: each kernel is built for 1, 2,
# 4 and 8 rows, and a group of 3, 5, 6 or 7 runs in the next of them.
KERNEL_GROUPS = tuple(range(1, 9))


def use_chunkdot(elem_dtype_name: str, sq: int, d: int, group: int, L: int) -> bool:
    """True when K5 serves the call in the seq layout: int8 cache, one query
    position, and the shapes K5 takes, head_dim 128, 1 to 8 query heads per
    KV head and a cache of ``L`` positions that JAX's tile divides
    (``_pick_lt``: where none does, JAX's plan serves no kernel, and K4 serves
    the call) with shares of at most ``K5_MAX_SHARE`` positions: every such
    L up to 32768, the longest context of the port's models.  The
    reference's ``use_chunkdot`` also takes any d % 128 == 0, groups above 8
    and longer caches; those tiers are not ported (K4 serves them)."""
    return (elem_dtype_name == "int8" and sq == 1 and d == 128 and group in KERNEL_GROUPS
            and _pick_lt(L) is not None and k5_share(L) <= K5_MAX_SHARE)


def use_int8dot(cache, sq: int, d: int, group: int = 1) -> bool:
    """True when K7 serves the call: the opt-in flag, an int8 d-major cache,
    one query position, and the shapes K7 takes (as ``use_chunkdot``)."""
    return (env.TORCHMX_ATTN_INT8_DOT == "1" and getattr(cache, "layout", "seq") == "dmajor"
            and cache.elem_dtype_name == "int8" and sq == 1 and d == 128 and group in KERNEL_GROUPS)


def cached_attention_any(q, cache, q_off: IntOrTensor, kv_len: IntOrTensor, sm_scale: float,
                         window=None, ring: bool = False, softcap=None) -> Optional[torch.Tensor]:
    """Causal attention of ``q (b, hq, sq, d)`` (RoPE applied) over an
    ``MXLayerKVCache`` holding the cache after the current tokens were
    written; ``q_off`` is the first query position and ``kv_len`` the
    visible prefix, each an int or a (b,) tensor.  None, on the CPU and on
    the card alike, where JAX's plan has no kernel for the head_dim (``d %
    128 != 0``): the caller then runs ``cached_attention_eager``.
    ``window``, ``ring`` and ``softcap`` are the reference's arguments; no
    kernel of the port takes them yet."""
    if window is not None or ring or softcap is not None:
        raise NotImplementedError("sliding windows, ring caches and soft caps are not ported yet")
    if cache.block_size != 32:
        raise ValueError("MX KV caches use block size 32")
    if q.shape[3] % 128:
        return None
    tensors = (cache.k_data, cache.k_scale, cache.v_data, cache.v_scale)
    group = q.shape[1] // cache.k_data.shape[1]
    if getattr(cache, "layout", "seq") == "dmajor":
        if use_int8dot(cache, q.shape[2], q.shape[3], group):
            return mx_cached_attention_int8dot(q, *tensors, q_off, kv_len, sm_scale)
        return mx_cached_attention_dmajor(q, *tensors, q_off, kv_len, sm_scale, cache.elem_dtype_name)
    if use_chunkdot(cache.elem_dtype_name, q.shape[2], q.shape[3], group, cache.k_data.shape[2]):
        return mx_cached_attention_chunkdot(q, *tensors, q_off, kv_len, sm_scale)
    return mx_cached_attention(q, *tensors, q_off, kv_len, sm_scale, cache.elem_dtype_name)


def cached_attention_eager(q, cache, q_off: IntOrTensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """JAX's eager route over an ``MXLayerKVCache`` (``torchmx_tpu/models/
    llama.py:745-782``), for the calls its plan serves by no kernel: the
    written cache dequantized to bf16, its KV heads shared by their query
    heads, bf16 scores from an fp32-accumulated product divided by
    sqrt(head_dim) (rounded to bf16 again), the standard cache mask (query t
    of row b sees positions ``<= q_off[b] + t``; float32's lowest finite value
    added elsewhere), an fp32 softmax rounded to bf16, and the P.V product
    accumulated in fp32, rounded to bf16.  PyTorch ops on the tensors'
    device (JAX leaves this route to XLA).  K and V are dequantized in one
    pass, and a KV head's query heads take one product each instead of a
    repeated cache (JAX's ``repeat_kv``: the same sums).  Positions past a
    row's last query are zeroed first: they are masked, and a stale scale
    there must not reach the products.  ``compute_dtype=torch.float64``
    computes the same function with no rounding between its steps (the
    checks' other rounding of it)."""
    b, hq, sq, d = q.shape
    hkv, dev = cache.k_data.shape[1], q.device
    G = hq // hkv
    f32 = compute_dtype or torch.float32  # the sums' type
    mid = compute_dtype or torch.bfloat16  # where JAX rounds to bf16
    kv = dequantize_cache(torch.cat([cache.k_data, cache.v_data]), torch.cat([cache.k_scale, cache.v_scale]),
                          cache.elem_dtype_name, cache.layout)  # (2b, hkv, L, d) bf16: K's rows, then V's
    L = kv.shape[2]
    q_pos = _per_row(q_off, b, dev)[:, None] + torch.arange(sq, device=dev)  # (b, sq)
    j = torch.arange(L, device=dev)
    live = (j[None] <= q_pos[:, -1:]).repeat(2, 1)[:, None, :, None]  # (2b, 1, L, 1)
    kv = torch.where(live, kv, 0).to(f32)
    k, v = kv[:b], kv[b:]
    qg = q.to(torch.bfloat16).to(f32).reshape(b, hkv, G * sq, d)  # heads ih G .. ih G + G - 1 of KV head ih
    s = (qg @ k.transpose(-1, -2)).to(mid)
    s = (s.to(f32) / math.sqrt(d)).to(mid).reshape(b, hq, sq, L)
    mask = torch.where(j[None, None] <= q_pos[:, :, None], 0.0, torch.finfo(torch.float32).min)[:, None]
    p = torch.softmax(s.to(f32) + mask.to(f32), dim=-1).to(mid)
    out = p.to(f32).reshape(b, hkv, G * sq, L) @ v
    return out.to(torch.bfloat16).reshape(b, hq, sq, d)
