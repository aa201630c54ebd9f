"""Absorbed multi-head latent attention (DeepSeek-V3 MLA) over a latent cache:
the kernels, their plain PyTorch versions, and ``mla_cached_attention``, the
dispatch the MLA layer calls (``torchmx_tpu/ops/pallas_mla.py``).

* B13 ``mx_mla_attention`` (``csrc/mx_mla.cu``) replaces ``_mla_kernel``:
  ``out = softmax(sm_scale * (q_lat . lat^T + q_rot . rot^T)) . lat`` over the
  seq-layout latent cache (bf16 ``MLACache``, or ``MXMLACache`` in fp8, fp6,
  int8 or halves-packed fp4), rows ``(query position, head)`` sharing the
  latent, per-row causal masking from ``q_off`` / ``kv_len``, prefill and
  decode alike.  Kernel and plain version: the positions cut into chunks of
  ``mla_chunk(L)`` (a function of the cache length alone) at fixed absolute
  positions, within a chunk an online softmax over tiles of ``B13_TILE``
  positions in fp32 (``p`` rounded to bf16 before ``p . lat``, masked
  scores ``-1e30``), then the chunks combined in chunk order; a row with no
  visible key outputs 0.  They differ in fp32 summation order and in the
  exponential's last bits only (the kernel takes the fast ``__expf``).  The
  kernel splits the chunks across the card and combines them in the same
  launch, through a workspace and tickets kept per device
  (``ops/split_kv``, shared with K7 and B14).
* B14 ``mx_mla_attention_int8dot`` (``csrc/mx_mla_int8dot.cu``) replaces
  ``_mla_kernel_int8dot``: decode (one query position) over an int8 d-major
  latent cache under ``TORCHMX_ATTN_INT8_DOT=1``, q and p quantized to int8
  and both dots exact, p requantized once per KV tile of JAX's
  ``_pick_lt(L)`` (``mx_mla_attention_int8dot_plain`` states the formula).
  The kernel quantizes q in its prologue, takes a tile a thread-block
  cluster (``b14_split``) and combines the tiles in the same launch.

``mla_cached_attention`` routes as the JAX function does: B14 where
``use_mla_int8dot`` says so, B13 where ``plan_mla_attention`` gives a plan,
and JAX's own eager route everywhere else (a d-major cache outside B14, a
block size other than 32, a cache length no tile divides):
``mla_eager_attention`` dequantizes the whole cache with ``read()``, in
PyTorch ops on the tensors' device, and is counted in ``ROUTES["eager"]``.
It is the reference design, not a fallback: a kernel that fails raises.

The int8 quantization of B14's query (one scale per row) uses a block of
the row's width, which K1's blocks of 32 do not take (nor does JAX's Pallas
quantizer: JAX runs it as jnp ops).  B14's kernel quantizes q in its
prologue with the per-row kernel's device functions; ``quantize_q_rows``
gives the same codes and scales by one launch of that kernel (``ops/
cuda_quantize.mx_quantize_rows``) on the card, by its plain version on the
CPU, bit for bit.  The d-major latent write goes through the per-row kernel
(``models/deepseek.MXMLACache.write``).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .. import env_variables as env
from ..mx_array import dequantize_mx
from ..packing import fp4_halves_to_pairs
from . import cuda_lib, split_kv
from .backend import on_cuda
from .cuda_attention import NEG_INF, IntOrTensor, _per_row, _pick_lt, _pow2_scale, row_args
from .cuda_norm import pairwise_sum
from .cuda_quantize import mx_quantize_rows, mx_quantize_rows_plain

B13_TILE = 32  # KV positions per online-softmax step of B13 (kT in csrc/mx_mla.cu)
KERNEL_R, KERNEL_DR = 512, 64  # the latent rank and rope width the kernels take
BLOCK = 32
MAX_ROWS = 256  # per-q-tile row budget of the JAX plan
MLA_FORMATS = ("bfloat16", "float8_e4m3", "float6_e3m2", "float6_e2m3", "int8", "float4_e2m1")

#: how often each route of ``mla_cached_attention`` ran: "eager" counts JAX's
#: dequantize-the-cache route (the kernels count in ``cuda_lib.LAUNCHES``).
ROUTES: "collections.Counter[str]" = collections.Counter()


# -- the tiling oracle (torchmx_tpu/ops/pallas_mla.py:234-257; _pick_lt in ops/cuda_attention) --------


def _pick_sqt(sq: int, g: int) -> Optional[int]:
    if sq * g <= MAX_ROWS:
        return sq
    for c in range(MAX_ROWS // g, 0, -1):
        if sq % c == 0 and (c * g) % 8 == 0:
            return c
    return None


def plan_mla_attention(n_heads: int, sq: int, L: int, r: int, dr: int, elem_name: str):
    """JAX's static oracle: a plan (not None) where its fused kernel serves
    the shape, None where it takes the eager route.  B13 serves exactly the
    shapes with a plan (on the card: r = 512, dr = 64)."""
    if elem_name not in MLA_FORMATS:
        return None
    if elem_name == "float4_e2m1":
        if r % (2 * BLOCK) or dr % (2 * BLOCK):
            return None
    elif elem_name != "bfloat16" and (r % BLOCK or dr % BLOCK):
        return None
    lt, sqt = _pick_lt(L), _pick_sqt(sq, n_heads)
    return None if lt is None or sqt is None else (lt, sqt)


def use_mla_int8dot(cache, sq: int, r: int, dr: int) -> bool:
    """True when B14 serves the call: the opt-in flag, an int8 d-major latent
    cache, one query position, and the widths B14 takes (r = 512, dr = 64;
    ``use_mla_int8dot`` of the reference takes any r % 128 and dr % 32, whose
    other widths are not ported)."""
    return (env.TORCHMX_ATTN_INT8_DOT == "1" and getattr(cache, "layout", "seq") == "dmajor"
            and cache.elem_dtype_name == "int8" and sq == 1 and r == KERNEL_R and dr == KERNEL_DR)


# -- B13 ------------------------------------------------------------------------------------------


def dequantize_latent(data: torch.Tensor, scale: torch.Tensor, elem_name: str) -> torch.Tensor:
    """A seq-layout latent (or rope key) buffer ``(b, L, w)`` (fp4: ``(b, L,
    w/2)`` halves-packed) to bf16 ``(b, L, w)``."""
    if elem_name == "bfloat16":
        return data.to(torch.bfloat16)
    if elem_name == "float4_e2m1":
        data = fp4_halves_to_pairs(data)
    return dequantize_mx(data, scale, elem_name, BLOCK, torch.bfloat16, 2)


def mla_chunk(L: int) -> int:
    """B13's KV chunk for a cache of ``L`` positions: the positions a CTA of
    the kernel walks, and the unit the plain version combines.  A function
    of ``L`` alone, so that a row's arithmetic does not depend on the batch,
    the query length or the visible prefix.  Each entry is the fastest chunk
    at the decode that caches of its lengths serve (``tools/phase_profile.py
    --kernel b13`` on an H100): generate's decode at b=32 over 256
    positions (64), the engine's over 1024 (128), b=32 over 2048 (256) and
    bench.py's b=8 over 8192 (512)."""
    if L > 512 * 64:  # at most 64 chunks (kMaxChunks in csrc/mx_mla.cu)
        return -(-L // (64 * B13_TILE)) * B13_TILE
    return 64 if L <= 256 else 128 if L <= 1024 else 256 if L <= 4096 else 512


def mx_mla_attention_plain(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale, q_off, kv_len,
                           sm_scale: float, elem_name: str, n_heads: int,
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of B13 over folded rows: ``q_lat (b, rows, r)`` and
    ``q_rot (b, rows, dr)`` bf16, rows ordered (query position, head) with
    ``n_heads`` heads, against the dequantized cache.  The positions are cut
    into chunks of ``mla_chunk(L)``; within a chunk an online softmax over
    tiles of ``B13_TILE`` positions (running max ``m`` and sum ``l``, ``p``
    rounded to bf16 before ``p . lat`` into ``acc``); then, in chunk order,
    ``M = max m_s`` and ``out = (sum acc_s e^(m_s - M)) * (1 / sum l_s
    e^(m_s - M))``.  Each dot is summed exactly (float64 over bf16 values)
    and rounded once, and a tile's ``l`` by a pairwise tree, so a row's
    bytes do not depend on the other rows.  ``compute_dtype=torch.float64``
    computes the same function with another rounding."""
    f, f64 = compute_dtype, torch.float64
    lat = dequantize_latent(lat_data, lat_scale, elem_name)
    rot = dequantize_latent(rot_data, rot_scale, elem_name)
    b, rows, r = q_lat.shape
    L, dev = lat.shape[1], q_lat.device
    q_off = _per_row(q_off, b, dev)
    kv_len = _per_row(kv_len, b, dev)
    # Positions at or past kv_len enter as 0, as in the kernel: a stale NaN
    # scale there must not reach the dots.
    live = (torch.arange(L, device=dev) < kv_len[:, None])[:, :, None]
    lat = torch.where(live, lat, 0).to(f64)
    rot = torch.where(live, rot, 0).to(f64)
    q_pos = (q_off[:, None] + torch.arange(rows, device=dev)[None] // n_heads)[:, :, None]
    ql, qr = q_lat.to(torch.bfloat16).to(f64), q_rot.to(torch.bfloat16).to(f64)
    S, end = mla_chunk(L), min(L, int(kv_len.max()))
    parts = []
    for c0 in range(0, end, S):
        m = torch.full((b, rows, 1), NEG_INF, dtype=f, device=dev)
        l = torch.zeros((b, rows, 1), dtype=f, device=dev)
        acc = torch.zeros((b, rows, r), dtype=f, device=dev)
        for t0 in range(c0, min(c0 + S, end), B13_TILE):
            lt, rt = lat[:, t0:t0 + B13_TILE], rot[:, t0:t0 + B13_TILE]
            kv_pos = torch.arange(t0, t0 + lt.shape[1], device=dev)
            s = (ql @ lt.transpose(1, 2) + qr @ rt.transpose(1, 2)).to(f) * sm_scale
            valid = (kv_pos <= q_pos) & (kv_pos < kv_len[:, None, None])
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(s - m_new), 0.0)
            l = l * alpha + pairwise_sum(p)[..., None]
            acc = acc * alpha + (p.to(torch.bfloat16).to(f64) @ lt).to(f)
            m = m_new
        parts.append((m, l, acc))
    if not parts:  # no row sees a key
        return torch.zeros((b, rows, r), dtype=torch.bfloat16, device=dev)
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(parts[0][1])
    o_all = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - m_all)
        l_all = l_all + l * w
        o_all = o_all + acc * w
    return (o_all * (1 / torch.where(l_all == 0, 1.0, l_all))).to(torch.bfloat16)


def _codes_dtype(elem_name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "int8": torch.int8}.get(elem_name, torch.uint8)


#: The most B13's combine workspace holds on a device (``ops/split_kv``, the
#: buffers B13, K7 and B14 share).  A call whose tiles could need more (an
#: admission of some thousand positions over a long cache, with ``kv_len`` a
#: tensor) is launched once per group of rows that fits.
B13_WORKSPACE_BYTES = 256 << 20


def b13_launch_groups(b: int, rows: int, n_heads: int, row_floats: int) -> list:
    """B13's launches for a call (``split_kv.launch_groups`` under
    ``B13_WORKSPACE_BYTES``): ``(first batch row, end, first query row,
    end)`` each; ``row_floats`` is the workspace a (batch row, query row)
    may need, a group of query rows a multiple of ``n_heads``."""
    return split_kv.launch_groups(b, rows, n_heads, row_floats, B13_WORKSPACE_BYTES)


def mx_mla_attention(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale, q_off, kv_len,
                     sm_scale: float, elem_name: str, n_heads: int, v_from_rot: bool = False,
                     drop_last_chunk: bool = False) -> torch.Tensor:
    """B13: ``(b, rows, r)`` bf16 from folded queries over the seq-layout
    latent cache (see ``mx_mla_attention_plain``).  CUDA tensors launch the
    kernel (r = 512, dr = 64, L % 32 == 0, 16-byte aligned cache buffers;
    other shapes raise), one launch a call where the combine's workspace
    fits ``B13_WORKSPACE_BYTES`` (``b13_launch_groups``).  The scales of a bf16 cache are
    ignored (pass any uint8 tensor).  Planted faults for the model check,
    never set by the package: ``v_from_rot`` makes the kernel read V from the
    rope key instead of the latent, ``drop_last_chunk`` makes its combine
    leave out the last live chunk of a tile."""
    if not on_cuda(q_lat, q_rot, lat_data, rot_data):
        return mx_mla_attention_plain(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale, q_off, kv_len,
                                      sm_scale, elem_name, n_heads)
    b, rows, r = q_lat.shape
    dr, L = q_rot.shape[2], lat_data.shape[1]
    pack = 2 if elem_name == "float4_e2m1" else 1
    if (elem_name not in MLA_FORMATS or r != KERNEL_R or dr != KERNEL_DR or L % B13_TILE or rows % n_heads
            or lat_data.shape != (b, L, r // pack) or rot_data.shape != (b, L, dr // pack)):
        raise ValueError(f"the MLA kernel takes r={KERNEL_R}, dr={KERNEL_DR}, L % {B13_TILE} == 0 and a "
                         f"{MLA_FORMATS} cache, got {elem_name} q_lat{tuple(q_lat.shape)} q_rot{tuple(q_rot.shape)} "
                         f"latent{tuple(lat_data.shape)} rope{tuple(rot_data.shape)}")
    cd = _codes_dtype(elem_name)
    bufs = (lat_data, rot_data) if elem_name == "bfloat16" else (lat_data, lat_scale, rot_data, rot_scale)
    for t in bufs:
        if not t.is_contiguous() or t.dtype not in (cd, torch.uint8) or t.data_ptr() % 16:
            raise ValueError(f"latent cache buffers must be contiguous, 16-byte aligned {cd} codes and uint8 scales")
    if elem_name != "bfloat16" and (lat_scale.shape != (b, L, r // BLOCK) or rot_scale.shape != (b, L, dr // BLOCK)):
        raise ValueError(f"latent scales must be ({b}, {L}, {r // BLOCK}) and ({b}, {L}, {dr // BLOCK})")
    if elem_name == "bfloat16":
        lat_scale = rot_scale = lat_data  # unread
    ql = q_lat.to(torch.bfloat16).contiguous()
    qr = q_rot.to(torch.bfloat16).contiguous()
    S = mla_chunk(L)
    # Where kv_len is a number, no chunk past it is launched (a CTA there
    # would only exit); a tensor is never read on the host.
    chunks = -(-L // S) if isinstance(kv_len, torch.Tensor) else max(1, -(-min(int(kv_len), L) // S))
    q_off = _per_row(q_off, b, ql.device)
    kv_len = _per_row(kv_len, b, ql.device)
    out = torch.empty_like(ql)
    row_floats = chunks * (r + 2) if chunks > 1 else 0
    groups = b13_launch_groups(b, rows, n_heads, row_floats)
    ws, tickets = split_kv.scratch(ql.device, max((i1 - i0) * (r1 - r0) for i0, i1, r0, r1 in groups) * row_floats,
                               max((i1 - i0) * -(-(r1 - r0) // 64) for i0, i1, r0, r1 in groups))
    elem = -1 if elem_name == "bfloat16" else cuda_lib.ELEM_CODES[elem_name]
    cache = [(t.data_ptr(), t.stride(0) * t.element_size()) for t in (lat_data, lat_scale, rot_data, rot_scale)]
    for i0, i1, r0, r1 in groups:
        row0 = i0 * rows + r0
        qo = q_off if r0 == 0 else q_off + r0 // n_heads  # a group of rows lies in one batch row
        cuda_lib.launch("mx_mla", "mx_mla_attention_launch", ql.data_ptr() + 2 * r * row0,
                        qr.data_ptr() + 2 * dr * row0, *(p + i0 * step for p, step in cache),
                        qo.data_ptr() + 4 * i0, kv_len.data_ptr() + 4 * i0, out.data_ptr() + 2 * r * row0,
                        ws.data_ptr(), tickets.data_ptr(), i1 - i0, r1 - r0, n_heads, L, r, dr, S, chunks,
                        float(sm_scale), elem, int(v_from_rot) | 2 * int(drop_last_chunk))
    return out


# -- B14 ------------------------------------------------------------------------------------------


def quantize_q_rows(q_lat: torch.Tensor, q_rot: torch.Tensor, sm_scale: float, plain: bool = False):
    """B14's query: ``q_lat (b, n, 1, r)`` and ``q_rot (b, n, 1, dr)`` to int8
    codes ``(b, n, w)`` with one scale per row, as f32 ``(b, n)`` with
    ``sm_scale`` folded in: ``(ql codes, ql scales, qr codes, qr scales)``,
    by one launch of the per-row kernel on the card (``plain``: by its plain
    version on either device)."""
    b, n = q_lat.shape[:2]
    quantize = mx_quantize_rows_plain if plain else mx_quantize_rows
    return quantize(q_lat.reshape(b, n, -1), q_rot.reshape(b, n, -1), "int8", sm_scale)


def _int8dot_check(q_lat, q_rot, lat_data, rot_data) -> None:
    b, n, sq, r = q_lat.shape
    if (sq != 1 or q_rot.shape[:3] != (b, n, 1) or lat_data.dtype != torch.int8 or rot_data.dtype != torch.int8
            or lat_data.shape[:2] != (b, r) or rot_data.shape[:2] != (b, q_rot.shape[3])):
        raise ValueError(f"int8-dot MLA takes one query position over an int8 d-major latent, got "
                         f"q_lat{tuple(q_lat.shape)} latent{tuple(lat_data.shape)} {lat_data.dtype}")


def b14_split(L: int) -> tuple:
    """B14's tiling of a cache of ``L`` positions: ``(lt, P)``, JAX's KV
    tile ``_pick_lt(L)`` (p is requantized once per tile) and the positions
    a CTA of the tile's cluster holds, 128 at tiles of up to 512 and 256
    above (``lt / P`` CTAs a tile: 2 at L = 256, 4 at 1024, 8 at 8192).
    Functions of ``L`` alone, so that a row's arithmetic does not depend on
    the batch or its visible prefix; ``(None, None)`` where no JAX tile
    divides ``L``."""
    lt = _pick_lt(L)
    return (None, None) if lt is None else (lt, 128 if lt <= 512 else 256)


def mx_mla_attention_int8dot_plain(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale, q_off, kv_len,
                                   sm_scale: float, tile: Optional[int] = None) -> torch.Tensor:
    """Plain version of B14, KV tile by KV tile (``tile`` positions, by
    default JAX's ``_pick_lt(L)``; the result depends on it): ``q_lat (b, n,
    1, r)`` / ``q_rot (b, n, 1, dr)`` bf16 over the d-major int8 latent ``(b,
    r, L)`` / ``(b, dr, L)`` with per-position scales ``(b, 1, L)``.  With
    ql, qr the int8 rows and qlsc, qrsc their f32 scales times sm_scale
    (``quantize_q_rows`` by the plain quantizer), pk(e) the float whose bits
    are e << 23:

    * ``s = (dot(ql, lat_j) * qlsc) * pk(el_j) + (dot(qr, rot_j) * qrsc) *
      pk(er_j)``, both dots exact integers;
    * j visible when ``j <= q_off`` and ``j < kv_len``, masked ``-1e30``,
      online softmax in fp32;
    * per tile ``p3 = p * pk(el_j)`` at visible j (0 elsewhere, whatever the
      stale scale), ``mx = max p3`` (1 where 0), ``pq = round_half_even(p3 *
      (127 / mx))``, ``acc = acc * alpha + (pq . lat^T) * (mx * (1/127))``;
    * ``out = acc / l`` (l = 1 where 0).

    At JAX's tile this is the JAX kernel's arithmetic, bit for bit on the
    CPU (but for hidden positions, which JAX multiplies by their scale).
    The kernel takes each tile's softmax against the tile's own maximum and
    combines the tiles at the end, so it differs in fp32 rounding and in
    rare ties of pq.  The integer dots run in float64, where they are
    exact."""
    _int8dot_check(q_lat, q_rot, lat_data, rot_data)
    b, n, _, r = q_lat.shape
    L, dev, f64 = lat_data.shape[2], q_lat.device, torch.float64
    tile = tile or _pick_lt(L)
    if tile is None:
        raise ValueError(f"int8-dot MLA takes a cache length one of JAX's tiles divides (L % 128 == 0), got {L}")
    qld, qlsc, qrd, qrsc = quantize_q_rows(q_lat, q_rot, sm_scale, plain=True)
    qld, qrd = qld.to(f64), qrd.to(f64)
    q_off = _per_row(q_off, b, dev)
    kv_len = _per_row(kv_len, b, dev)
    visible = torch.minimum(kv_len, q_off + 1).clamp(max=L)
    m = torch.full((b, n, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n, r), dtype=torch.float32, device=dev)
    for t0 in range(0, int(visible.max()), tile):
        lt = lat_data[:, :, t0:t0 + tile].to(f64)
        rt = rot_data[:, :, t0:t0 + tile].to(f64)
        T = lt.shape[2]
        valid = (torch.arange(t0, t0 + T, device=dev) < visible[:, None])[:, None, :]  # (b, 1, T)
        pkl = _pow2_scale(lat_scale[:, :, t0:t0 + tile])  # (b, 1, T)
        pkr = _pow2_scale(rot_scale[:, :, t0:t0 + tile])
        s_l = (qld @ lt).to(torch.float32)
        s_r = (qrd @ rt).to(torch.float32)
        s = (s_l * qlsc[..., None]) * pkl + (s_r * qrsc[..., None]) * pkr
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p3 = torch.where(valid, p * pkl, 0.0)
        mx = p3.amax(dim=-1, keepdim=True)
        mx = torch.where(mx == 0, 1.0, mx)
        pq = torch.round(p3 * (127.0 / mx))
        pv = (pq.to(f64) @ lt.transpose(1, 2)).to(torch.float32)
        acc = acc * alpha + pv * (mx * (1.0 / 127.0))
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out[:, :, None, :].to(torch.bfloat16)


def mx_mla_attention_int8dot(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale, q_off, kv_len,
                             sm_scale: float, drop_last_tile: bool = False,
                             q_out: Optional[tuple] = None) -> torch.Tensor:
    """B14: ``(b, n, 1, r)`` bf16 (see ``mx_mla_attention_int8dot_plain``).
    CUDA tensors launch the kernel, which quantizes q itself (r = 512, dr =
    64, a cache length one of JAX's tiles divides, 16-byte aligned cache
    buffers; other shapes raise), one launch a call: a tile of JAX's
    ``_pick_lt(L)`` a cluster of ``lt / P`` CTAs (``b14_split``), the tiles
    combined in the same launch; where ``kv_len`` is a number only the tiles
    below it are launched, and where ``q_off`` is one too both go to the
    kernel as numbers.  ``q_out``, four tensors shaped as
    ``quantize_q_rows``' result, receives the codes and scales the kernel
    computed for q (on the CPU, the plain quantizer's).  ``drop_last_tile``
    (the combine leaves out the last live tile of a row) is a planted fault
    for the checks, never set by the package."""
    if not on_cuda(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale):
        if q_out is not None:
            for dst, src in zip(q_out, quantize_q_rows(q_lat, q_rot, sm_scale, plain=True)):
                dst.copy_(src)
        return mx_mla_attention_int8dot_plain(q_lat, q_rot, lat_data, lat_scale, rot_data, rot_scale, q_off,
                                              kv_len, sm_scale)
    _int8dot_check(q_lat, q_rot, lat_data, rot_data)
    b, n, _, r = q_lat.shape
    dr, L = q_rot.shape[3], lat_data.shape[2]
    lt, P = b14_split(L)
    if r != KERNEL_R or dr != KERNEL_DR or lt is None or lat_data.shape != (b, r, L) or rot_data.shape != (b, dr, L):
        raise ValueError(f"the int8-dot MLA kernel takes r={KERNEL_R}, dr={KERNEL_DR} and L % 128 == 0, got "
                         f"q_lat{tuple(q_lat.shape)} q_rot{tuple(q_rot.shape)} latent{tuple(lat_data.shape)} "
                         f"rope{tuple(rot_data.shape)}")
    if lat_scale.shape != (b, 1, L) or rot_scale.shape != (b, 1, L) or lat_scale.dtype != torch.uint8 \
            or rot_scale.dtype != torch.uint8:
        raise ValueError(f"per-position scales must be ({b}, 1, {L}) uint8")
    for t in (lat_data, lat_scale, rot_data, rot_scale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("latent cache buffers must be contiguous and 16-byte aligned")
    ql = q_lat.to(torch.bfloat16).reshape(b, n, r).contiguous()
    qr = q_rot.to(torch.bfloat16).reshape(b, n, dr).contiguous()
    # Where kv_len is a number, no tile past it is launched; a tensor is never read on the host.  Where
    # both are numbers they go to the kernel as they are (no fill launches).
    tiles = L // lt if isinstance(kv_len, torch.Tensor) else max(1, -(-min(int(kv_len), L) // lt))
    _keep, pos = row_args(q_off, kv_len, b, ql.device)
    out = torch.empty((b, n, 1, r), dtype=torch.bfloat16, device=ql.device)
    nr = 16 if n <= 16 else 32  # heads a cluster takes (NR in csrc/mx_mla_int8dot.cu)
    units = b * -(-n // nr)
    ws, tickets = split_kv.scratch(ql.device, units * tiles * nr * (r + 4 * (lt // P)) if tiles > 1 else 0,
                                   units * (lt // P))
    q_ptrs = (None,) * 4
    if q_out is not None:
        want = ((b, n, r), (b, n), (b, n, dr), (b, n))
        if any(t.shape != w or t.dtype != d or not t.is_contiguous() or t.device != ql.device
               for t, w, d in zip(q_out, want, (torch.int8, torch.float32) * 2)):
            raise ValueError("q_out must be contiguous tensors shaped as quantize_q_rows' result")
        q_ptrs = tuple(t.data_ptr() for t in q_out)
    cuda_lib.launch("mx_mla_int8dot", "mx_mla_attention_int8dot_launch", ql.data_ptr(), qr.data_ptr(),
                    lat_data.data_ptr(), lat_scale.data_ptr(), rot_data.data_ptr(), rot_scale.data_ptr(),
                    *pos, out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), *q_ptrs,
                    b, n, L, r, dr, lt, P, tiles, float(sm_scale), int(drop_last_tile))
    return out


# -- the dispatch (torchmx_tpu/models/deepseek.py:498-533, ops/pallas_mla.py:260-341) -------------------


def mla_eager_attention(q_lat, q_rot, cache, q_off: IntOrTensor, sm_scale: float) -> torch.Tensor:
    """JAX's eager route: the whole cache dequantized by ``read()``, fp32
    scores over every position with the causal mask of ``q_off``, an fp32
    softmax rounded to bf16, ``p . lat`` in fp32 rounded to bf16.  Positions
    past the last query's are zeroed first (a stale scale there must not
    reach the products)."""
    ROUTES["eager"] += 1
    b, n, sq, _ = q_lat.shape
    lat, rot = cache.read()  # (b, L, r) / (b, L, dr) bf16
    L, dev = lat.shape[1], lat.device
    q_pos = _per_row(q_off, b, dev)[:, None] + torch.arange(sq, device=dev)  # (b, sq)
    j = torch.arange(L, device=dev)
    live = (j[None] < q_pos[:, -1:] + 1)[:, :, None]
    lat = torch.where(live, lat, 0).to(torch.float32)
    rot = torch.where(live, rot, 0).to(torch.float32)
    s = q_lat.to(torch.float32) @ lat[:, None].transpose(-1, -2)
    s = s + q_rot.to(torch.float32) @ rot[:, None].transpose(-1, -2)
    s = s * sm_scale
    visible = (j[None, None] <= q_pos[:, :, None])[:, None]  # (b, 1, sq, L)
    s = torch.where(visible, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(torch.bfloat16)
    return (p.to(torch.float32) @ lat[:, None]).to(torch.bfloat16)


def mla_cached_attention(q_lat, q_rot, cache, q_off: IntOrTensor, kv_len: IntOrTensor,
                         sm_scale: float) -> torch.Tensor:
    """Absorbed attention of ``q_lat (b, n, sq, r)`` and ``q_rot (b, n, sq,
    dr)`` (RoPE applied) over an ``MXMLACache`` or ``MLACache`` holding the
    cache after the current tokens were written; ``q_off`` is the first query
    position and ``kv_len`` the visible prefix, each an int or a (b,)
    tensor.  Returns ``(b, n, sq, r)`` bf16, to be folded through the V half
    of ``kv_b_proj`` by the caller."""
    b, n, sq, r = q_lat.shape
    dr = q_rot.shape[3]
    if hasattr(cache, "lat_data"):  # MXMLACache
        elem = cache.elem_dtype_name
        if cache.block_size != BLOCK:
            return mla_eager_attention(q_lat, q_rot, cache, q_off, sm_scale)
        if cache.layout == "dmajor":
            if (use_mla_int8dot(cache, sq, r, dr) and _pick_lt(cache.max_len) is not None
                    and n <= MAX_ROWS):
                return mx_mla_attention_int8dot(q_lat, q_rot, *cache.buffers, q_off, kv_len, sm_scale)
            return mla_eager_attention(q_lat, q_rot, cache, q_off, sm_scale)
        tensors = cache.buffers
    else:  # MLACache
        elem = "bfloat16"
        tensors = (cache.latent, cache.latent, cache.k_rot, cache.k_rot)
    if plan_mla_attention(n, sq, cache.max_len, r, dr, elem) is None:
        return mla_eager_attention(q_lat, q_rot, cache, q_off, sm_scale)

    def fold(q):  # (b, n, sq, x) -> (b, sq * n, x), rows ordered (query position, head)
        return q.to(torch.bfloat16).transpose(1, 2).reshape(b, sq * n, q.shape[3])

    out = mx_mla_attention(fold(q_lat), fold(q_rot), *tensors, q_off, kv_len, sm_scale, elem, n)
    return out.reshape(b, sq, n, r).transpose(1, 2)
