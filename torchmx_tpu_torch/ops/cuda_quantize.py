"""K1 ``mx_quantize``, K2 ``mx_fake_quantize`` and ``mx_quantize_rows``: CUDA
kernels (``csrc/mx_quantize.cu``) and their plain PyTorch versions.

K1 and K2 replace ``torchmx_tpu/ops/pallas_quantize.py``'s ``_quantize_kernel``
(bf16 -> E8M0 scale + hw-exact RNE codes) and ``_fake_quantize_kernel`` /
``_fake_quantize_lane_kernel`` (quantize-dequantize in one pass with the fp32
magic-number RNE).  Both kernels are bit-exact to their plain versions over
every bf16 bit pattern (checked on the card by ``chip_smoke.py``).  One body
serves every mode: a thread takes 8 consecutive elements in one 16-byte
load, four lanes make a block, each thread stores its 8 results as one
vector, and the grid is sized from the card's SM count.

Fake-quantize contract: ``mx_fake_quantize(x) == dequantize_mx(quantize_mx(x))``
bit for bit, including the flush of results below the fp32 normal range to a
signed zero that ``dequantize_mx`` inherits from the reference.

K1 also writes in B9's dot order (``mx_quantize_dot``): each block's codes
under the permutation of K in which B9's W fragments come out of
``ldmatrix.trans`` (:data:`DOT_ORDER`), its scales transposed to ``(K/32,
Mp)`` as the f32 factors ``2^(se-127)`` (bits ``se << 23``), Mp = M rounded
up to 16 (:func:`dot_scale_width`): a stage of B9 reads its two scale rows
as one TMA box and multiplies by them as they are.

K2 also writes in B7's plane order (``mx_fake_quantize_planes``): x's even
elements, then its odd ones, each plane zero-padded to ``pair_width(K) / 2``
columns, as ``_pallas_matmul_fp4`` splits x before its kernel; with an
activation format each 32-element block of the row is fake-quantized at its
joint scale over both planes (``_fq_xT_pair``), without one it is a copy.

K1 also writes a layer's new K and V straight into ``MXLayerKVCache``'s four
buffers (``mx_cache_write``): both in one launch, in the seq or the d-major
layout, at an int position or per-row positions clamped as XLA clamps
``dynamic_update_slice``, fp4 in its d-halves packing.  Its plain version
``mx_cache_write_plain`` quantizes each by ``mx_quantize_plain`` and stores
the rows by indexed stores.

``mx_quantize_rows`` quantizes with one exponent per row (block = the row's
width), which K1's blocks of 32 do not take: MLA's d-major latent write and
B14's query (``ops/cuda_mla``, ``models/deepseek``).  JAX runs it as jnp ops
(no Pallas kernel), so the kernel is a repair of the port, bit for bit
``quantize_mx_plain(x, elem, w)``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import dtypes
from ..mx_array import quantize_mx_plain
from ..packing import fp4_pairs_to_halves
from ..mx_quantization import (
    F32_MIN_NORMAL,
    bf16_bits,
    f32_from_bits,
    get_e8m0_shared_exponent,
    leading_one_position,
)
from . import cuda_lib
from .backend import on_cuda
from .cuda_attention import _pow2_scale

BLOCK = 32


def _sms(device: torch.device) -> int:
    """The card's SM count: the kernels size their grids from it."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's storage starts on 16 bytes (the kernels' vector loads and stores)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_kernel_input(x: torch.Tensor, block_size: int) -> torch.Tensor:
    if block_size != BLOCK:
        raise ValueError(f"the CUDA kernels take block_size {BLOCK}, got {block_size}")
    if x.dtype != torch.bfloat16 or x.shape[-1] % BLOCK:
        raise ValueError(f"need bf16 with a last dim multiple of {BLOCK}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or not _aligned(x):
        raise ValueError("the quantize kernels need a contiguous input starting on 16 bytes")
    return x


def mx_quantize_plain(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (scale (..., K/bs) uint8, codes (..., K) uint8,
    int8 for int8, fp4 pair-packed (..., K/2))."""
    return quantize_mx_plain(x, elem_dtype_name, block_size)


def mx_quantize(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: quantize along the last dim.  CUDA tensors launch the kernel."""
    if not on_cuda(x):
        return mx_quantize_plain(x, elem_dtype_name, block_size)
    _check_kernel_input(x, block_size)
    K = x.shape[-1]
    lead = tuple(x.shape[:-1])
    scale = torch.empty(lead + (K // BLOCK,), dtype=torch.uint8, device=x.device)
    width = K // 2 if elem_dtype_name == "float4_e2m1" else K
    cdt = torch.int8 if elem_dtype_name == "int8" else torch.uint8
    codes = torch.empty(lead + (width,), dtype=cdt, device=x.device)
    cuda_lib.launch(
        "mx_quantize", "mx_quantize_launch",
        x.data_ptr(), scale.data_ptr(), codes.data_ptr(),
        x.numel() // K, K, cuda_lib.ELEM_CODES[elem_dtype_name], _sms(x.device),
    )
    return scale, codes


# B9's dot order: position 16h + 4q + j of a 32-element block holds element
# 16h + 2q + (j & 1) + 8 (j >> 1), where B9's register A fragments from
# ldmatrix.trans put W's codes (csrc/mx_matmul_int8dot.cu).
DOT_ORDER = tuple(16 * h + 2 * q + (j & 1) + 8 * (j >> 1) for h in range(2) for q in range(4) for j in range(4))
DOT_FORMATS = ("int8", "float8_e4m3")  # B9's code formats


def dot_scale_width(M: int) -> int:
    """Columns of the dot-order mode's transposed scales: M rounded up to 16
    (a TMA row pitch is a multiple of 16 bytes)."""
    return -(-M // 16) * 16


def to_dot_order(codes: torch.Tensor) -> torch.Tensor:
    """``(..., K)`` codes, each 32-block permuted into :data:`DOT_ORDER`."""
    K = codes.shape[-1]
    order = torch.tensor(DOT_ORDER, device=codes.device)
    return codes.reshape(*codes.shape[:-1], K // BLOCK, BLOCK)[..., order].reshape(codes.shape)


def from_dot_order(codes: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_dot_order`."""
    K = codes.shape[-1]
    inverse = torch.argsort(torch.tensor(DOT_ORDER, device=codes.device))
    return codes.reshape(*codes.shape[:-1], K // BLOCK, BLOCK)[..., inverse].reshape(codes.shape)


def mx_quantize_dot_plain(x: torch.Tensor, elem_dtype_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1's dot-order mode: ``x (M, K)`` quantized as
    :func:`mx_quantize_plain` does, returned as (the scales transposed as f32
    factors ``2^(se-127)``, ``(K/32, Mp)`` with zeros in columns M .. Mp - 1;
    the codes ``(M, K)`` in :data:`DOT_ORDER`)."""
    M, K = x.shape
    se, codes = quantize_mx_plain(x, elem_dtype_name, BLOCK)
    px_t = torch.zeros((K // BLOCK, dot_scale_width(M)), dtype=torch.float32, device=x.device)
    px_t[:, :M] = f32_from_bits(se.t().to(torch.int32) << 23)
    return px_t, to_dot_order(codes)


def mx_quantize_dot(x: torch.Tensor, elem_dtype_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 in B9's dot order (see :func:`mx_quantize_dot_plain`), int8 or
    e4m3 codes of a 2-D bf16 x.  CUDA tensors launch the kernel, counted as
    ``mx_quantize``."""
    if elem_dtype_name not in DOT_FORMATS:
        raise ValueError(f"the dot-order mode takes {DOT_FORMATS}, got {elem_dtype_name!r}")
    if x.dim() != 2:
        raise ValueError(f"the dot-order mode takes a 2-D x, got {tuple(x.shape)}")
    if not on_cuda(x):
        return mx_quantize_dot_plain(x, elem_dtype_name)
    _check_kernel_input(x, BLOCK)
    M, K = x.shape
    px_t = torch.empty((K // BLOCK, dot_scale_width(M)), dtype=torch.float32, device=x.device)
    codes = torch.empty((M, K), dtype=torch.int8 if elem_dtype_name == "int8" else torch.uint8, device=x.device)
    cuda_lib.launch("mx_quantize", "mx_quantize_dot_launch", x.data_ptr(), px_t.data_ptr(), codes.data_ptr(),
                    M, K, px_t.shape[1], cuda_lib.ELEM_CODES[elem_dtype_name], _sms(x.device), name="mx_quantize")
    return px_t, codes


def mx_fake_quantize_plain(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> torch.Tensor:
    """Plain version of K2 (``_fq_magic_cast`` of the reference): clamp to
    ``max * 2^(se-127)``, round to the MX quantum ``2^qe`` by
    ``(|x| + M) - M`` in fp32, re-apply the sign, flush results below the
    fp32 normal range, NaN for NaN-scale blocks."""
    elem = dtypes.STR_TO_SUPPORTED_ELEM_DTYPE[elem_dtype_name]
    shape = x.shape
    xb = x.reshape(-1, block_size)
    bits = bf16_bits(xb)
    se = get_e8m0_shared_exponent(xb, elem).to(torch.int32)[:, None]

    tmant = int(round((elem.max / 2.0**elem.max_pow2 - 1.0) * 2**23))
    t_field = se + elem.max_pow2
    t = f32_from_bits(torch.where(t_field >= 255, 0x7F800000, (t_field << 23) | tmant))
    a = torch.minimum(xb.to(torch.float32).abs(), t)
    if elem == dtypes.int8:
        qe = (se - 127).expand(bits.shape)
    else:
        mb = elem.mantissa_bits
        e_x = (bits >> 7) & 0xFF
        man = bits & 0x7F
        e_eff = torch.where((e_x == 0) & (man != 0), leading_one_position(man) - 6, e_x)
        qe = torch.maximum(e_eff - 127 - mb, se + (1 - elem.exponent_bias - mb - 127))
    big = qe > 100  # keep the magic constant fp32-normal
    mg = f32_from_bits(((qe - torch.where(big, 64, 0) + 150) << 23) | 0x400000)
    a = torch.where(big, a * 2.0**-64, a)
    r = (a + mg) - mg
    r = torch.where(big, r * 2.0**64, r)
    sgn = (bits.to(torch.int64) & 0x8000) << 16
    if elem == dtypes.int8:
        sgn = torch.where(r == 0, 0, sgn)  # int8 has no signed zero
    r = torch.where(r < F32_MIN_NORMAL, 0.0, r)
    y = f32_from_bits(r.view(torch.int32).to(torch.int64) | sgn).to(torch.bfloat16)
    y = torch.where(se == 255, float("nan"), y)
    return y.reshape(shape)


def mx_fake_quantize_kernel(
    x: torch.Tensor, elem_dtype_name: str, block_size: int = BLOCK
) -> torch.Tensor:
    """K2 on a CUDA tensor: one pass, bf16 in and out."""
    _check_kernel_input(x, block_size)
    out = torch.empty_like(x)
    K = x.shape[-1]
    cuda_lib.launch(
        "mx_quantize", "mx_fake_quantize_launch",
        x.data_ptr(), out.data_ptr(), x.numel() // K, K, cuda_lib.ELEM_CODES[elem_dtype_name], _sms(x.device),
    )
    return out


PLANE_FORMATS = (None, "float8_e4m3", "int8")  # the plane mode's activation formats (B7's)


def pair_width(K: int) -> int:
    """Columns of x in B7's plane order: two planes of K/2 columns, each
    zero-padded to a multiple of 64 (the kernel's stage slice)."""
    return -(-K // 128) * 128


def mx_fake_quantize_planes_plain(x: torch.Tensor, elem_dtype_name: Optional[str] = None) -> torch.Tensor:
    """Plain version of K2's plane mode: ``x (M, K)`` fake-quantized (if
    ``elem_dtype_name``) by :func:`mx_fake_quantize_plain`, whose blocks are
    32 consecutive elements of a row, then split into ``[even K | odd K]``
    planes of ``pair_width(K) / 2`` columns each, zeros past K/2."""
    M, K = x.shape
    if elem_dtype_name is not None:
        x = mx_fake_quantize_plain(x, elem_dtype_name)
    half = pair_width(K) // 2
    out = torch.zeros((M, 2 * half), dtype=torch.bfloat16, device=x.device)
    out[:, :K // 2] = x[:, 0::2]
    out[:, half:half + K // 2] = x[:, 1::2]
    return out


def mx_fake_quantize_planes(x: torch.Tensor, elem_dtype_name: Optional[str] = None) -> torch.Tensor:
    """K2 in B7's plane order (see :func:`mx_fake_quantize_planes_plain`).
    CUDA tensors launch the kernel: counted as ``mx_fake_quantize`` with an
    activation format, as ``mx_pair_planes`` for the copy without one."""
    if elem_dtype_name not in PLANE_FORMATS:
        raise ValueError(f"the plane mode takes {PLANE_FORMATS}, got {elem_dtype_name!r}")
    if not on_cuda(x):
        return mx_fake_quantize_planes_plain(x, elem_dtype_name)
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.shape[1] % BLOCK or not _aligned(x):
        raise ValueError(f"the plane mode needs a contiguous 2-D bf16 x with K % {BLOCK} == 0, got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    out = torch.empty((M, pair_width(K)), dtype=torch.bfloat16, device=x.device)
    elem = -1 if elem_dtype_name is None else cuda_lib.ELEM_CODES[elem_dtype_name]
    cuda_lib.launch("mx_quantize", "mx_fake_quantize_planes_launch", x.data_ptr(), out.data_ptr(), M, K,
                    out.shape[1], elem, _sms(x.device),
                    name="mx_pair_planes" if elem_dtype_name is None else "mx_fake_quantize")
    return out


CachePosition = Union[int, torch.Tensor]
CACHE_FP4_HEAD_DIMS = (32, 64, 128, 256)  # fp4 d-halves partners within one warp of the cache write


def _check_cache_write(k_new, v_new, buffers, elem_dtype_name, layout, pos) -> int:
    """The cache's length after checking the write: ``(b, kv, s, d)`` K and V,
    buffers ``(k codes, k scales, v codes, v scales)`` of the layout, a
    start that fits (an int) or a ``(b,)`` tensor on the cache's device."""
    b, kv, s, d = k_new.shape
    dmajor = layout == "dmajor"
    L = buffers[0].shape[3 if dmajor else 2]
    dp = d // 2 if elem_dtype_name == "float4_e2m1" else d
    data, scale = ((b, kv, dp, L), (b, kv, d // BLOCK, L)) if dmajor else ((b, kv, L, dp), (b, kv, L, d // BLOCK))
    if v_new.shape != k_new.shape or any(t.shape != want for t, want in zip(buffers, (data, scale, data, scale))):
        raise ValueError(f"a {layout} cache write takes K and V {tuple(k_new.shape)} into buffers {data} / {scale}, "
                         f"got V {tuple(v_new.shape)} and {[tuple(t.shape) for t in buffers]}")
    if isinstance(pos, torch.Tensor):
        if pos.shape != (b,) or pos.device != buffers[0].device:
            raise ValueError(f"per-row positions must be a ({b},) tensor on {buffers[0].device}, "
                             f"got {tuple(pos.shape)} on {pos.device}")
        if s > L:
            raise ValueError(f"cache of length {L} cannot take {s} positions")
    elif pos < 0 or pos + s > L:
        raise ValueError(f"cache of length {L} cannot take positions {pos} .. {pos + s}")
    return L


def mx_cache_write_plain(k_new: torch.Tensor, v_new: torch.Tensor, buffers: Sequence[torch.Tensor],
                         elem_dtype_name: str, layout: str, pos: CachePosition) -> None:
    """Plain version of K1's cache write: ``k_new`` and ``v_new`` ``(b, kv,
    s, d)`` quantized along d by :func:`mx_quantize_plain` (fp4 then re-packed
    as d-halves), stored in ``buffers`` (``MXLayerKVCache``'s k codes, k
    scales, v codes, v scales, in the ``"seq"`` or ``"dmajor"`` layout) at
    positions ``[pos, pos + s)``, in place.  ``pos`` is an int, or a ``(b,)``
    tensor with one start a row, clamped to ``[0, L - s]`` as XLA clamps
    ``dynamic_update_slice``.  The rows go in with one indexed store per
    buffer, the indices built on the device."""
    L = _check_cache_write(k_new, v_new, buffers, elem_dtype_name, layout, pos)
    b, _, s, _ = k_new.shape
    per_row = isinstance(pos, torch.Tensor)
    if per_row:
        dev = pos.device
        rows = torch.arange(b, device=dev)[:, None]
        cols = pos.long().clamp(0, L - s)[:, None] + torch.arange(s, device=dev)
    for new, data, scale in ((k_new, *buffers[:2]), (v_new, *buffers[2:])):
        sc, codes = mx_quantize_plain(new.to(torch.bfloat16).contiguous(), elem_dtype_name)
        if elem_dtype_name == "float4_e2m1":
            codes = fp4_pairs_to_halves(codes)
        if layout == "dmajor":  # views with the sequence on dim 2: the stores below write through them
            data, scale = data.transpose(2, 3), scale.transpose(2, 3)
        if per_row:  # data[rows, :, cols] is (b, s, kv, x)
            data[rows, :, cols] = codes.transpose(1, 2)
            scale[rows, :, cols] = sc.transpose(1, 2)
        else:
            data[:, :, pos:pos + s] = codes
            scale[:, :, pos:pos + s] = sc


def mx_cache_write(k_new: torch.Tensor, v_new: torch.Tensor, buffers: Sequence[torch.Tensor], elem_dtype_name: str,
                   layout: str, pos: CachePosition) -> None:
    """K1's cache write (see :func:`mx_cache_write_plain`).  CUDA tensors
    launch the kernel once for K and V, counted as ``mx_quantize``: bf16 K
    and V whose last dim is contiguous (any strides of the others that are
    multiples of 8 elements), contiguous buffers; fp4 at head_dim 32, 64,
    128 or 256.  Other inputs raise."""
    if not on_cuda(k_new, v_new, *buffers, pos if isinstance(pos, torch.Tensor) else None):
        return mx_cache_write_plain(k_new, v_new, buffers, elem_dtype_name, layout, pos)
    L = _check_cache_write(k_new, v_new, buffers, elem_dtype_name, layout, pos)
    b, kv, s, d = k_new.shape
    k_new, v_new = (t if t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:3]) and _aligned(t)
                    else t.contiguous() for t in (k_new, v_new))
    fp4 = elem_dtype_name == "float4_e2m1"
    if (k_new.dtype != torch.bfloat16 or v_new.dtype != torch.bfloat16 or d % BLOCK
            or (fp4 and d not in CACHE_FP4_HEAD_DIMS) or not all(t.is_contiguous() for t in buffers)):
        raise ValueError(f"the cache write kernel takes bf16 K/V with d % {BLOCK} == 0 (fp4: d in "
                         f"{CACHE_FP4_HEAD_DIMS}) and contiguous buffers, got {k_new.dtype} {tuple(k_new.shape)}")
    per_row = isinstance(pos, torch.Tensor)
    p = pos.to(torch.int32).contiguous() if per_row else None
    cuda_lib.launch(
        "mx_quantize", "mx_cache_write_launch",
        k_new.data_ptr(), *k_new.stride()[:3], v_new.data_ptr(), *v_new.stride()[:3],
        *(t.data_ptr() for t in buffers), None if p is None else p.data_ptr(), 0 if per_row else int(pos),
        b, kv, s, d, L, cuda_lib.ELEM_CODES[elem_dtype_name], int(layout == "dmajor"), _sms(k_new.device),
        name="mx_quantize",
    )


ROW_FORMATS = ("float8_e4m3", "float6_e3m2", "float6_e2m3", "int8")  # the d-major caches' formats
ROW_MAX_WIDTH = 1024  # 32 elements a lane of the kernel's warp


def _check_rows(x1, x2, elem_dtype_name, out, pos) -> None:
    if elem_dtype_name not in ROW_FORMATS:
        raise ValueError(f"row quantization takes {ROW_FORMATS}, got {elem_dtype_name}")
    if x1.shape[:-1] != x2.shape[:-1]:
        raise ValueError(f"the pair must share its rows, got {tuple(x1.shape)} and {tuple(x2.shape)}")
    if out is None:
        return
    if x1.dim() != 3:
        raise ValueError(f"a d-major write takes (b, s, w) rows, got {tuple(x1.shape)}")
    b, s = x1.shape[:2]
    L = out[0].shape[2]
    for x, data, scale in ((x1, out[0], out[1]), (x2, out[2], out[3])):
        if data.shape != (b, x.shape[2], L) or scale.shape != (b, 1, L):
            raise ValueError(f"d-major buffers must be ({b}, {x.shape[2]}, {L}) and ({b}, 1, {L}), got "
                             f"{tuple(data.shape)} and {tuple(scale.shape)}")
    if not isinstance(pos, torch.Tensor) or pos.shape != (b,) or pos.device != out[0].device:
        raise ValueError(f"per-row positions must be a ({b},) tensor on {out[0].device}, got {pos!r}")
    if s > L:
        raise ValueError(f"cache of length {L} cannot take {s} positions")


def mx_quantize_rows_plain(x1: torch.Tensor, x2: torch.Tensor, elem_dtype_name: str, sm_scale: float = 1.0,
                           out: Optional[Sequence[torch.Tensor]] = None, pos: Optional[torch.Tensor] = None):
    """Plain version of ``mx_quantize_rows``: each of ``x1 (..., w1)`` and
    ``x2 (..., w2)`` by ``quantize_mx_plain`` at block = its width, then

    * ``out=None``: returns ``(codes1, scale1, codes2, scale2)``, codes
      ``(..., w)`` (int8 for int8, else uint8) and f32 row scales ``(...)``
      equal to ``pk(se) * sm_scale`` (pk(e): the float whose bits are e << 23);
    * ``out=(data1, scale1, data2, scale2)``, the d-major buffers ``(b, w,
      L)`` / ``(b, 1, L)``, and ``pos`` a ``(b,)`` tensor: rows ``(b, s, w)``
      stored at columns ``clamp(pos, 0, L - s) + t`` (as XLA clamps
      ``dynamic_update_slice``), in place; returns None."""
    _check_rows(x1, x2, elem_dtype_name, out, pos)
    quantized = [quantize_mx_plain(x.to(torch.bfloat16).contiguous(), elem_dtype_name, x.shape[-1])
                 for x in (x1, x2)]
    if out is None:
        return tuple(v for se, codes in quantized for v in (codes, _pow2_scale(se[..., 0]) * sm_scale))
    b, s = x1.shape[:2]
    dev, L = x1.device, out[0].shape[2]
    rows = torch.arange(b, device=dev)[:, None]
    cols = pos.long().clamp(0, L - s)[:, None] + torch.arange(s, device=dev)
    for (se, codes), data, scale in zip(quantized, out[0::2], out[1::2]):
        data.transpose(1, 2)[rows, cols] = codes.to(data.dtype)
        scale.transpose(1, 2)[rows, cols] = se
    return None


def mx_quantize_rows(x1: torch.Tensor, x2: torch.Tensor, elem_dtype_name: str, sm_scale: float = 1.0,
                     out: Optional[Sequence[torch.Tensor]] = None, pos: Optional[torch.Tensor] = None):
    """MX quantization with one E8M0 exponent per row of a pair of inputs
    sharing their rows (see ``mx_quantize_rows_plain``).  CUDA tensors launch
    the kernel once for both (widths multiples of 32 up to 1024, bf16 rows,
    contiguous buffers; other inputs raise)."""
    if not on_cuda(x1, x2, *(out or ()), pos):
        return mx_quantize_rows_plain(x1, x2, elem_dtype_name, sm_scale, out, pos)
    _check_rows(x1, x2, elem_dtype_name, out, pos)
    w1, w2 = x1.shape[-1], x2.shape[-1]
    if x1.dtype != torch.bfloat16 or x2.dtype != torch.bfloat16 or any(
            w % BLOCK or not 0 < w <= ROW_MAX_WIDTH for w in (w1, w2)):
        raise ValueError(f"the row quantize kernel takes bf16 rows of widths multiple of {BLOCK} up to "
                         f"{ROW_MAX_WIDTH}, got {x1.dtype} {tuple(x1.shape)} and {x2.dtype} {tuple(x2.shape)}")
    x1, x2 = x1.contiguous(), x2.contiguous()
    cd = torch.int8 if elem_dtype_name == "int8" else torch.uint8
    rows = x1.numel() // w1
    if out is None:
        lead = tuple(x1.shape[:-1])
        result = (torch.empty(lead + (w1,), dtype=cd, device=x1.device),
                  torch.empty(lead, dtype=torch.float32, device=x1.device),
                  torch.empty(lead + (w2,), dtype=cd, device=x1.device),
                  torch.empty(lead, dtype=torch.float32, device=x1.device))
        bufs, p, s, L = result, None, 1, 1
    else:
        if not all(t.is_contiguous() for t in out) or out[0].dtype != cd or out[2].dtype != cd or any(
                t.dtype != torch.uint8 for t in out[1::2]):
            raise ValueError(f"d-major buffers must be contiguous {cd} codes and uint8 scales")
        result, bufs, s, L = None, out, x1.shape[1], out[0].shape[2]
        p = pos.to(torch.int32).contiguous()
    cuda_lib.launch(
        "mx_quantize", "mx_quantize_rows_launch",
        x1.data_ptr(), x2.data_ptr(), *(t.data_ptr() for t in bufs), None if p is None else p.data_ptr(),
        rows, s, L, w1, w2, cuda_lib.ELEM_CODES[elem_dtype_name], float(sm_scale), int(out is not None),
    )
    return result
