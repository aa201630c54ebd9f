"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the repository root with one card:  python3 chip_smoke.py

Phases, each on ``cuda``; any failure raises and the script exits non-zero:

1. device: name, and name + power limit from nvidia-smi;
2. kernels: builds the four CUDA kernels from ``torchmx_tpu_torch/csrc`` and
   holds each against its plain PyTorch version on the card (K1/K2
   bit-exact over all 2^16 bf16 patterns in all five formats, and at every
   main-path shape; K3 rel <= 1e-2 and K4 abs <= 2e-2, each at every
   main-path shape), then
   times kernel, plain version and, where one exists, the one PyTorch call
   computing the same function (CUDA events, median of 20, L2 flushed
   before each call);
3. model check: a 2-layer model at Llama-3-8B width, seeded random weights,
   b=2, 16 greedy tokens; at every step, from the same tokens and cache,
   kernel path against plain path on the same card: each decoder layer's
   update and lm_head's logits teacher-forced from the plain path's hidden
   state, the end-to-end logits (L2 rel, gates in GATES), and the tokens
   wherever the plain top-2 gap exceeds 0.1.  The plain path with float64
   attention must pass the same gates, and each of three planted kernel
   faults must fail one;
4. the slice: Llama-3-8B (32 layers) with MXFP4 weights, MXFP8 activations
   and an fp8 KV cache, built layer by layer from a seed, greedy generation
   of 128 tokens after a 64-token prompt at batch 1 and 32.  The launch
   counts are set to 0 just before each timed ``generate`` and read just
   after (prefill and per decode step from the same run); each kernel must
   have launched.  Then, outside that run: time to first token, the
   synchronised gap between tokens, and a torch.profiler window giving
   device time per decode step by kernel and the device's idle share.

The line before last is a JSON object describing every kernel; the last is
``{"ok": true, "device": {...}}``.  ``--layers N`` cuts the slice's depth.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, data sheet
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                 rope_theta=500000.0)
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call.

    Before each call the device sleeps for about 1 ms, so the host has
    enqueued the start event, the call and the end event before the device
    reaches them: the events time the device's work alone, not the wrapper's
    Python and launch overhead (which the slice's breakdown shows as idle
    time)."""

    SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz

    def __init__(self, dev):
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(bytes_: float, ops: float = 0.0):
    t_b, t_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# -- phase 2: kernels ----------------------------------------------------------


def all_bf16_blocks(dev) -> torch.Tensor:
    b = torch.arange(65536, dtype=torch.int32)
    return torch.where(b >= 32768, b - 65536, b).to(torch.int16).view(torch.bfloat16).reshape(-1, 32).to(dev)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the elements, NaN against NaN and equal infinities
    counting as 0, NaN against a number as inf."""
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, 0.0, (a - b).abs().nan_to_num(nan=float("inf")))
    return d.max().item()


# Shapes the slice's main path gives K1 (fp8: K/V cache writes at prefill
# and decode; fp4: the projection and lm_head weights, (out, in)) and K2 (the
# shared activation fake-quantize at batch-32 prefill and its warm-up).
K1_MAIN_SHAPES = {"float8_e4m3": [(1, 8, 64, 128), (32, 8, 64, 128), (32, 8, 1, 128)],
                  "float4_e2m1": [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                                  (128256, 4096)]}
K2_MAIN_SHAPES = [(2048, 4096), (256, 4096)]


def check_quantize_kernels(dev, timer, gen):
    from torchmx_tpu_torch.mx_array import dequantize_mx
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    def randn(shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * torch.exp2(torch.randn(shape, generator=gen, device=dev) * 3)).to(torch.bfloat16)

    def compare(name, label, x, fq_too):
        s, c = cq.mx_quantize(x, name)
        sp, cp = cq.mx_quantize_plain(x, name)
        bad = int((s != sp).sum()) + int((c.view(torch.uint8) != cp.view(torch.uint8)).sum())
        err1 = max_abs_diff(dequantize_mx(c, s, name, 32, torch.float32, x.dim() - 1),
                            dequantize_mx(cp, sp, name, 32, torch.float32, x.dim() - 1))
        log(f"K1 mx_quantize {name} {label}: {bad} mismatching scale/code bytes")
        err2 = 0.0
        if fq_too:
            fq, fp = cq.mx_fake_quantize_kernel(x, name), cq.mx_fake_quantize_plain(x, name)
            nan = torch.isnan(fq.float()) & torch.isnan(fp.float())
            bad_fq = int(((fq.view(torch.int16) != fp.view(torch.int16)) & ~nan).sum())
            err2 = max_abs_diff(fq, fp)
            log(f"K2 mx_fake_quantize {name} {label}: {bad_fq} mismatching values")
            bad += bad_fq
        if bad:
            raise AssertionError(f"{name} {label}: quantize kernels differ from plain")
        return err1, err2

    worst1 = worst2 = 0.0
    x_all, x_rand = all_bf16_blocks(dev), randn((4096, 4096))
    for name in ("float8_e4m3", "float4_e2m1", "float6_e3m2", "float6_e2m3", "int8"):
        e1, e2 = compare(name, "all bf16 patterns", x_all, True)
        worst1, worst2 = max(worst1, e1), max(worst2, e2)
    for name in ("float8_e4m3", "float4_e2m1"):
        e1, e2 = compare(name, "random 4096x4096", x_rand, True)
        worst1, worst2 = max(worst1, e1), max(worst2, e2)
        for shape in K1_MAIN_SHAPES[name]:
            worst1 = max(worst1, compare(name, f"main-path {shape}", randn(shape), False)[0])
    for shape in K2_MAIN_SHAPES:
        x = randn(shape)
        fq, fp = cq.mx_fake_quantize_kernel(x, "float8_e4m3"), cq.mx_fake_quantize_plain(x, "float8_e4m3")
        err = max_abs_diff(fq, fp)
        log(f"K2 mx_fake_quantize float8_e4m3 main-path {shape}: max abs err {err}")
        if err != 0.0:
            raise AssertionError(f"K2 {shape}: differs from plain")
    # Timing at main-path shapes: K1 on the batch-32 prefill K write
    # (32, 8, 64, 128); K2 on the batch-32 prefill activation (2048, 4096).
    k = torch.randn(32, 8, 64, 128, generator=gen, device=dev).to(torch.bfloat16)
    a = torch.randn(2048, 4096, generator=gen, device=dev).to(torch.bfloat16)
    out = []
    n = k.numel()
    t_b, by = bound(2 * n + n + n / 32)
    out.append(dict(name="mx_quantize", route="cuda", source="torchmx_tpu_torch/csrc/mx_quantize.cu",
                    replaces="torchmx_tpu/ops/pallas_quantize.py:137",
                    shape="fp8 (32, 8, 64, 128)", max_abs_err=worst1,
                    ms=timer(lambda: cq.mx_quantize(k, "float8_e4m3")),
                    plain_ms=timer(lambda: cq.mx_quantize_plain(k, "float8_e4m3"), reps=5),
                    bound_ms=t_b, bound_by=by, library_ms=None))
    n = a.numel()
    t_b, by = bound(4 * n)
    out.append(dict(name="mx_fake_quantize", route="cuda", source="torchmx_tpu_torch/csrc/mx_quantize.cu",
                    replaces="torchmx_tpu/ops/pallas_quantize.py:217",
                    shape="fp8 (2048, 4096)", max_abs_err=worst2,
                    ms=timer(lambda: cq.mx_fake_quantize_kernel(a, "float8_e4m3")),
                    plain_ms=timer(lambda: cq.mx_fake_quantize_plain(a, "float8_e4m3"), reps=5),
                    bound_ms=t_b, bound_by=by, library_ms=None))
    return out


# The slice's projections as (K, N) and the activation fake-quantize each
# gets at prefill, when rows > 64 (q/k/v and gate/up read an activation
# fake-quantized once by K2, so K3 runs without act_fq; o_proj and down_proj
# fuse it).  lm_head sees only the last position (M = batch).
K3_MAIN_LINEARS = {"q_proj/o_proj": (4096, 4096), "k_proj/v_proj": (4096, 1024),
                   "gate_proj/up_proj": (4096, 14336), "down_proj": (14336, 4096),
                   "lm_head": (4096, 128256)}
K3_PREFILL_SHARED_FQ = {"q_proj/o_proj", "k_proj/v_proj", "gate_proj/up_proj"}


def check_matmul_kernel(dev, timer, gen):
    from torchmx_tpu_torch.mx_array import MXTensor
    from torchmx_tpu_torch.ops import cuda_matmul as cm

    weights = {}
    for label, (K, N) in K3_MAIN_LINEARS.items():
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        weights[label] = MXTensor.to_mx(w, "float4_e2m1").T.to_fp4_halves()
    worst = 0.0  # max abs error

    def check(x, label, act):
        nonlocal worst
        w = weights[label]
        (M, K), N = x.shape, w.shape[1]
        o = cm.mx_matmul_fp4_halves(x, w.data, w.scale_e8m0, act)
        r = cm.mx_matmul_fp4_halves_plain(x, w.data, w.scale_e8m0, act)
        err = (o.float() - r.float()).abs().max().item()
        rel = err / r.float().abs().max().item()
        worst = max(worst, err)
        log(f"K3 mx_matmul_fp4_halves M={M} N={N} K={K} act_fq={act}: rel err {rel:.3e}")
        if not rel <= 1e-2:
            raise AssertionError(f"K3 M={M} N={N} K={K} act_fq={act}: rel {rel}")

    def xs(M, K):
        return torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)

    for M in (1, 32, 256):  # the fixed grid
        x = xs(M, 4096)
        for label in ("q_proj/o_proj", "gate_proj/up_proj"):
            for act in (None, "float8_e4m3"):
                check(x, label, act)
    # Every (M, K, N, act_fq) the main path gives K3: decode at batch 1 and
    # 32, prefill of 64 tokens at batch 1 (M = 64, fused fq) and 32 (M = 2048).
    path_calls = []
    for label, (K, N) in K3_MAIN_LINEARS.items():
        for M in (1, 32) if label == "lm_head" else (1, 32, 64, 2048):
            act = None if (M == 2048 and label in K3_PREFILL_SHARED_FQ) else "float8_e4m3"
            path_calls.append((label, M, act))
            check(xs(M, K), label, act)
    # Timing at every main-path call; the JSON entry is the batch-32 decode
    # gate/up shape (M=32, N=14336, K=4096) with fused fp8 act fq.
    rows = []
    for label, M, act in path_calls:
        w = weights[label]
        K, N = w.shape
        x = xs(M, K)
        w_bf16 = cm.dequantize_fp4_halves(w.data, w.scale_e8m0)
        t_b, by = bound(2 * M * K + K * N / 2 + K * N / 32 + 2 * M * N, 2 * M * N * K)
        row = dict(linear=label, M=M, N=N, K=K, act_fq=act,
                   ms=timer(lambda: cm.mx_matmul_fp4_halves(x, w.data, w.scale_e8m0, act)),
                   plain_ms=timer(lambda: cm.mx_matmul_fp4_halves_plain(x, w.data, w.scale_e8m0, act), reps=5),
                   library_ms=timer(lambda: torch.matmul(x, w_bf16)),
                   bound_ms=t_b, bound_by=by)
        log("K3 timing", json.dumps(row))
        rows.append(row)
        del w_bf16
    pick = next(r for r in rows if r["M"] == 32 and r["N"] == 14336)
    return dict(name="mx_matmul_fp4_halves", route="cuda", source="torchmx_tpu_torch/csrc/mx_matmul.cu",
                replaces="torchmx_tpu/ops/pallas_matmul.py:504",
                shape="M=32 N=14336 K=4096 act_fq=float8_e4m3", max_abs_err=worst,
                ms=pick["ms"], plain_ms=pick["plain_ms"], bound_ms=pick["bound_ms"],
                bound_by=pick["bound_by"], library_ms=pick["library_ms"]), rows


def _attn_case(dev, gen, b, hq, hkv, d, L, sq, kv_len):
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    k = torch.randn(b, hkv, L, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, hkv, L, d, generator=gen, device=dev).to(torch.bfloat16)
    ks, kd = cq.mx_quantize(k, "float8_e4m3")
    vs, vd = cq.mx_quantize(v, "float8_e4m3")
    q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return (q, kd, ks, vd, vs, kv - sq, kv, d ** -0.5, "float8_e4m3")


def _attn_work(args):
    """(bytes, operations) the attention must move and do for these inputs:
    q and out once, the visible K/V codes and scales once per KV head, and
    two dots over each query's visible keys."""
    q, kd, *_ = args
    b, hq, sq, d = q.shape
    hkv = kd.shape[1]
    kv_len = args[6].tolist()
    q_off = args[5].tolist()
    nbytes = 2 * 2 * q.numel()
    ops = 0
    for i in range(b):
        nbytes += 2 * hkv * kv_len[i] * (d + d // 32)
        visible = sum(min(q_off[i] + j + 1, kv_len[i]) for j in range(sq))
        ops += 4 * hq * d * visible
    return nbytes, ops


def check_attention_kernel(dev, timer, gen):
    import torch.nn.functional as F

    from torchmx_tpu_torch.mx_array import dequantize_mx
    from torchmx_tpu_torch.ops import cuda_attention as ca

    worst = 0.0
    rows = []
    # hq=32, hkv=8, d=128 throughout.  A ragged batch over a long cache, then
    # the main path's calls: prefill of 64 tokens and decode over a cache of
    # 256 positions (64 + 128 rounded up to 128) at batch 1 and 32.
    cases = [("ragged b=4 L=1024 sq=64", 4, 1024, 64, [1024, 777, 300, 70]),
             ("ragged b=4 L=1024 sq=1", 4, 1024, 1, [1024, 777, 300, 70]),
             ("decode b=32 L=256 kv=192", 32, 256, 1, [192] * 32),
             ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32),
             ("decode b=1 L=256 kv=192", 1, 256, 1, [192]),
             ("prefill b=1 L=256 sq=64", 1, 256, 64, [64])]
    for label, b, L, sq, kv in cases:
        args = _attn_case(dev, gen, b, 32, 8, 128, L, sq, kv)
        q, kd, ks, vd, vs, q_off, kv_len, scale, _ = args
        err = (ca.mx_cached_attention(*args).float() - ca.mx_cached_attention_plain(*args).float()).abs().max().item()
        worst = max(worst, err)
        log(f"K4 mx_cached_attention {label}: max abs err {err:.3e}")
        if not err <= 2e-2:
            raise AssertionError(f"K4 {label}: abs err {err}")
        k = dequantize_mx(kd, ks, "float8_e4m3", 32, torch.bfloat16, 3)
        v = dequantize_mx(vd, vs, "float8_e4m3", 32, torch.bfloat16, 3)
        pos = q_off[:, None] + torch.arange(sq, device=dev)[None]
        j = torch.arange(L, device=dev)
        mask = ((j <= pos[..., None]) & (j < kv_len[:, None, None]))[:, None]
        nbytes, ops = _attn_work(args)
        t_b, by = bound(nbytes, ops)
        row = dict(case=label, ms=timer(lambda: ca.mx_cached_attention(*args)),
                   plain_ms=timer(lambda: ca.mx_cached_attention_plain(*args), reps=5),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)),
                   bound_ms=t_b, bound_by=by)
        log("K4 timing", json.dumps(row))
        rows.append(row)
    pick = rows[2]
    return dict(name="mx_cached_attention", route="cuda", source="torchmx_tpu_torch/csrc/mx_attention.cu",
                replaces="torchmx_tpu/ops/pallas_attention.py:115",
                shape="decode b=32 hq=32 hkv=8 d=128 L=256 kv_len=192 fp8 cache", max_abs_err=worst,
                ms=pick["ms"], plain_ms=pick["plain_ms"], bound_ms=pick["bound_ms"],
                bound_by=pick["bound_by"], library_ms=pick["library_ms"]), rows


# -- phase 3 and 4: the model ----------------------------------------------------


def quant_configs():
    from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig

    q = QLinearConfig(MXConfig("float4_e2m1"), MXConfig("float8_e4m3"))
    return QAttentionConfig(q), q, MXConfig("float8_e4m3")


@contextlib.contextmanager
def f64_plain_attention():
    """The plain K4 computed in float64: the same function with another
    rounding, to measure how far the model alone carries such a difference."""
    import functools

    from torchmx_tpu_torch.ops import cuda_attention as ca

    plain = ca.mx_cached_attention_plain
    ca.mx_cached_attention_plain = functools.partial(plain, compute_dtype=torch.float64)
    try:
        yield
    finally:
        ca.mx_cached_attention_plain = plain


# Wrong kernels the model check must catch, each emulated at its wrapper on
# the kernel path only (under plain_path() the wrapper is left alone).
PLANTED_FAULTS = ("K4 causal mask one position late", "K4 kv_len one short",
                  "K3 fused activation fq skipped")


@contextlib.contextmanager
def planted_fault(name):
    from torchmx_tpu_torch.ops import cuda_attention as ca
    from torchmx_tpu_torch.ops import matmul as mm
    from torchmx_tpu_torch.ops.backend import on_cuda

    if name.startswith("K4"):
        mod, attr = ca, "mx_cached_attention"
        orig = ca.mx_cached_attention

        def faulty(q, kd, ks, vd, vs, q_off, kv_len, *rest):
            if on_cuda(q):
                if "causal" in name:
                    q_off = q_off + 1
                else:
                    kv_len = kv_len - 1
            return orig(q, kd, ks, vd, vs, q_off, kv_len, *rest)
    else:
        mod, attr = mm, "mx_matmul_fp4_halves"
        orig = mm.mx_matmul_fp4_halves

        def faulty(x, w_data, w_scale, act_fq=None):
            return orig(x, w_data, w_scale, None if on_cuda(x) else act_fq)
    setattr(mod, attr, faulty)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _copy_cache(c):
    from torchmx_tpu_torch.models.llama import MXLayerKVCache

    return MXLayerKVCache(c.k_data.clone(), c.k_scale.clone(), c.v_data.clone(),
                          c.v_scale.clone(), c.elem_dtype_name, c.block_size)


def teacher_forced(model, ids, caches, pos, floor: bool):
    """One step, layer by layer from the plain path's hidden state: each
    decoder layer's update (output minus input) on the kernel path, from a
    copy of the same cache, against the plain path's; then lm_head on the
    same final hidden state.  With ``floor``, also the plain path with
    float64 attention against the plain path, layer by layer.  Advances
    ``caches`` by the plain path.  Returns (worst layer rel, lm_head rel,
    worst layer floor or None, plain logits of the last row)."""
    from torchmx_tpu_torch.models.llama import rope_cos_sin
    from torchmx_tpu_torch.ops.backend import plain_path

    m = model.model
    b, s = ids.shape
    x = m.embed_tokens[ids]
    position_ids = torch.arange(pos, pos + s, device=x.device)[None].expand(b, s)
    cos, sin = rope_cos_sin(m.inv_freq, position_ids, x.dtype)
    worst, worst_floor = 0.0, None
    for layer, cache in zip(m.layers, caches):
        kw = dict(cos=cos, sin=sin, cache_position=pos)
        got = layer(x, cache=_copy_cache(cache), **kw)
        with plain_path():
            if floor:
                with f64_plain_attention():
                    ref64 = layer(x, cache=_copy_cache(cache), **kw)
            ref = layer(x, cache=cache, **kw)
        update = ref.float() - x.float()
        worst = max(worst, _rel(got.float() - x.float(), update))
        if floor:
            worst_floor = max(worst_floor or 0.0, _rel(ref64.float() - x.float(), update))
        x = ref
    h = m.norm(x[:, -1:])
    got = model.logits(h)[:, -1]
    with plain_path():
        ref = model.logits(h)[:, -1]
    return worst, _rel(got, ref), worst_floor, ref.float()


def model_readings(model, prompt, n, kv, floor: bool) -> dict:
    """Greedy n tokens on the kernel path, then every step again from the
    same tokens and the same cache (the kernel path's, copied): end-to-end
    logits (L2 rel) kernel vs plain, the teacher-forced per-layer and lm_head
    readings, decisive-token disagreements, and (with ``floor``) the plain
    path against itself with float64 attention."""
    from torchmx_tpu_torch.models.generate import generate
    from torchmx_tpu_torch.ops.backend import plain_path

    tokens = generate(model, prompt, n, kv_cache_config=kv)
    caches = model.init_cache(prompt.shape[0], 128, kv)
    r = dict(logits=0.0, layer=0.0, lm_head=0.0, floor_logits=None, floor_layer=None,
             near_ties=0, decisive_flips=0,
             generate_mismatch=0, finite=True)
    step_in, pos = prompt, 0
    with torch.inference_mode():
        for i in range(n):
            snap = [_copy_cache(c) for c in caches]
            snap64 = [_copy_cache(c) for c in caches] if floor else None
            got = model(step_in, caches=caches, cache_position=pos, last_only=True)[:, -1].float()
            layer, head, layer_floor, ref = teacher_forced(model, step_in, snap, pos, floor)
            r["logits"] = max(r["logits"], _rel(got, ref))
            r["layer"], r["lm_head"] = max(r["layer"], layer), max(r["lm_head"], head)
            if floor:
                with plain_path(), f64_plain_attention():
                    ref64 = model(step_in, caches=snap64, cache_position=pos, last_only=True)[:, -1]
                r["floor_logits"] = max(r["floor_logits"] or 0.0, _rel(ref64, ref))
                r["floor_layer"] = max(r["floor_layer"] or 0.0, layer_floor)
            top2 = ref.topk(2, dim=-1).values
            decisive = (top2[:, 0] - top2[:, 1]) > 0.1
            r["near_ties"] += int((~decisive).sum())
            r["decisive_flips"] += int(((got.argmax(-1) != ref.argmax(-1)) & decisive).sum())
            r["generate_mismatch"] += int((got.argmax(-1) != tokens[:, i]).sum())
            r["finite"] &= bool(torch.isfinite(got).all())
            pos += step_in.shape[1]
            step_in = tokens[:, i:i + 1]
    return r


# Gates of the model check (L2 rel), each between the readings of sound
# code and the smallest reading of a planted fault (PERF.md, PR 1 on the
# H100): a teacher-forced decoder layer's update, sound 1.84e-2 (kernels)
# and 3.17e-2 (plain path with float64 attention), faults >= 8.08e-2;
# lm_head, sound 2e-6, faults >= 3.02e-2; end-to-end logits, which carry
# the fp8 amplification of every rounding difference through both layers,
# sound 4.38e-2 and 6.56e-2, faults >= 9.44e-2.
GATES = {"layer": 5e-2, "lm_head": 2e-2, "logits": 8e-2}


def gate_failures(r: dict) -> list:
    out = [] if r["finite"] else ["non-finite logits"]
    out += [f"{key} rel {r[key]:.3e} > {gate:g}" for key, gate in GATES.items() if not r[key] <= gate]
    if r["decisive_flips"]:
        out.append(f"{r['decisive_flips']} tokens differ at decisive steps")
    if r["generate_mismatch"] and not out:
        out.append(f"generate() picked {r['generate_mismatch']} other tokens")
    return out


def model_check(dev, card) -> dict:
    """Kernel path vs plain path on the same card, 2 layers at 8B width, b=2,
    16 greedy tokens; then again with each planted fault, which must fail a
    gate.  Every reading is printed before any gate is applied."""
    from torchmx_tpu_torch.models.llama import LlamaConfig
    from torchmx_tpu_torch.quant_api import build_quantized_llama

    qa, qm, kv = quant_configs()
    cfg = LlamaConfig(**{**LLAMA3_8B, "num_hidden_layers": 2})
    model = build_quantized_llama(cfg, qa, qm, dev, torch.Generator(dev).manual_seed(1))
    prompt = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator(dev).manual_seed(2), device=dev)
    readings = {"sound": model_readings(model, prompt, 16, kv, floor=True)}
    for fault in PLANTED_FAULTS:
        with planted_fault(fault):
            readings[fault] = model_readings(model, prompt, 16, kv, floor=False)
    del model
    for name, r in readings.items():
        log(f"model check [{name}]: 2 layers at 8B width, b=2, 16 greedy tokens: {json.dumps(r)} [{card}]")
    sound = readings["sound"]
    bad = gate_failures(sound)
    if bad:
        raise AssertionError(f"model check: {'; '.join(bad)}")
    for key in ("layer", "logits"):  # another rounding of correct code passes too
        if not sound[f"floor_{key}"] <= GATES[key]:
            raise AssertionError(f"model check: the plain path with float64 attention fails the {key} gate "
                                 f"({sound[f'floor_{key}']:.3e} > {GATES[key]:g})")
    for fault in PLANTED_FAULTS:
        caught = gate_failures(readings[fault])
        if not caught:
            raise AssertionError(f"model check: planted fault '{fault}' passes every gate")
        log(f"model check: planted fault '{fault}' caught: {'; '.join(caught)}")
    log(f"model check passed: gates {json.dumps(GATES)} [{card}]")
    return readings


def run_slice(dev, card, layers: int):
    from torchmx_tpu_torch.models.generate import generate
    from torchmx_tpu_torch.models.llama import LlamaConfig
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.quant_api import build_quantized_llama

    qa, qm, kv = quant_configs()
    cfg = LlamaConfig(**{**LLAMA3_8B, "num_hidden_layers": layers})
    if layers != LLAMA3_8B["num_hidden_layers"]:
        log(f"slice: depth cut to {layers} of 32 layers")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    model = build_quantized_llama(cfg, qa, qm, dev, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"slice: built and quantized Llama-3-8B ({layers} layers) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card [{card}]")
    log(f"slice: launches while building (weight quantization, not the main path): "
        f"{json.dumps(dict(cuda_lib.LAUNCHES))}")
    # The counts at the start of every forward of the timed run: the first
    # is the prefill, the rest are decode steps.
    at_forward = []
    hook = model.register_forward_pre_hook(
        lambda *_: at_forward.append(collections.Counter(cuda_lib.LAUNCHES)))
    results, launches = {}, collections.Counter()
    for b in (1, 32):
        prompt = torch.randint(0, cfg.vocab_size, (b, 64), generator=torch.Generator(dev).manual_seed(b), device=dev)
        generate(model, prompt[:, :8], 4, kv_cache_config=kv)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at_forward.clear()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tokens, logits = generate(model, prompt, 128, kv_cache_config=kv, return_logits=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run = collections.Counter(cuda_lib.LAUNCHES)
        if tokens.shape != (b, 128) or not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"slice b={b}: bad tokens {tokens.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"slice b={b}: non-finite logits")
        steps = len(at_forward) - 1
        peak = torch.cuda.max_memory_allocated() / 2**30
        tps = b * 128 / dt
        launches.update(run)
        results[b] = dict(batch=b, seconds=dt, tokens_per_s=tps, peak_gib=peak, launches=dict(run),
                          launches_prefill=dict(at_forward[1] - at_forward[0]),
                          launches_per_decode_step={k: v / steps for k, v in (run - at_forward[1]).items()})
        log(f"slice: b={b} prompt 64 + 128 new tokens in {dt:.3f} s = {tps:.1f} tok/s, "
            f"peak {peak:.2f} GiB; launches {json.dumps(results[b]['launches'])}, of which prefill "
            f"{json.dumps(results[b]['launches_prefill'])}, per decode step "
            f"{json.dumps(results[b]['launches_per_decode_step'])} [{card}]")
    hook.remove()
    for b in (1, 32):
        results[b].update(latency_and_device_time(model, cfg, kv, dev, b, results[b]["seconds"]))
        log(f"slice breakdown b={b}: {json.dumps(results[b])} [{card}]")
    return dict(launches), results


KERNEL_OF_DEVICE_NAME = (  # substring of the CUDA function name -> kernel
    ("matmul_fp4_halves_kernel", "mx_matmul_fp4_halves"),
    ("reduce_splits_kernel", "mx_matmul_fp4_halves"),
    ("fake_quantize_kernel", "mx_fake_quantize"),
    ("quantize_kernel", "mx_quantize"),
    ("attention_kernel", "mx_cached_attention"),
)


def device_time_by_kernel(prof) -> dict:
    """ms of device activity in a profile, by kernel of the port and
    'pytorch' for everything else, plus 'busy' (union of all intervals)."""
    spans, by = [], collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = next((k for s, k in KERNEL_OF_DEVICE_NAME if s in e.name), "pytorch")
        by[name] += (t1 - t0) / 1e3
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return dict(by, busy=busy / 1e3)


def latency_and_device_time(model, cfg, kv, dev, b: int, generate_seconds: float) -> dict:
    """The slice's per-token numbers at batch b, outside the timed generate:
    time to first token and the gap between tokens as a streaming caller sees
    them (each step ends in a synchronise; median and p90 of 127 gaps), and,
    from a torch.profiler window of 8 decode steps, the device time per step
    by kernel and the device's idle share of the unsynchronised decode step
    that ``generate`` runs."""
    prompt = torch.randint(0, cfg.vocab_size, (b, 64), generator=torch.Generator(dev).manual_seed(b), device=dev)
    caches = model.init_cache(b, 256, kv)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = model(prompt, caches=caches, cache_position=0, last_only=True)[:, -1].argmax(-1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        gaps = []
        for i in range(127):
            t0 = time.perf_counter()
            tok = model(tok[:, None], caches=caches, cache_position=64 + i)[:, -1].argmax(-1)
            torch.cuda.synchronize()
            gaps.append(time.perf_counter() - t0)
        caches = model.init_cache(b, 256, kv)
        model(prompt, caches=caches, cache_position=0, last_only=True)
        steps = 8
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(steps):
                tok = model(tok[:, None], caches=caches, cache_position=64 + i)[:, -1].argmax(-1)
            torch.cuda.synchronize()
    gaps.sort()
    # generate(): one prefill, then 127 decode steps without a synchronise.
    step_ms = (generate_seconds - ttft) / 127 * 1e3
    out = dict(ttft_ms=ttft * 1e3, gap_ms_median=statistics.median(gaps) * 1e3,
               gap_ms_p90=gaps[int(0.9 * len(gaps))] * 1e3, gap_samples=len(gaps),
               generate_decode_step_ms=step_ms)
    dev_ms = device_time_by_kernel(prof)
    if dev_ms["busy"] > 0:
        per_step = {k: v / steps for k, v in dev_ms.items()}
        out["device_ms_per_decode_step"] = per_step
        out["device_idle_share"] = 1.0 - per_step["busy"] / step_ms
        if out["device_idle_share"] < 0:
            log(f"WARNING: b={b}: device busy {per_step['busy']:.3f} ms per decode step exceeds the "
                f"step of {step_ms:.3f} ms: the profiler window or the step count is wrong")
    else:
        out["device_ms_per_decode_step"] = "not measured (the profiler recorded no device events)"
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32, help="depth of the slice's model (default 32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchmx_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    cuda_lib.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s into {cuda_lib.BUILD_DIR}")
    timer = Timer(dev)
    gen = torch.Generator(dev).manual_seed(1234)
    kernels = check_quantize_kernels(dev, timer, gen)
    k3, k3_rows = check_matmul_kernel(dev, timer, gen)
    k4, k4_rows = check_attention_kernel(dev, timer, gen)
    kernels += [k3, k4]
    check_readings = model_check(dev, card)
    launches, slice_results = run_slice(dev, card, args.layers)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        k["launches_per_decode_step"] = {
            f"b{b}": r["launches_per_decode_step"].get(k["name"], 0) for b, r in slice_results.items()}
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, matmul=k3_rows, attention=k4_rows,
                       model_check=check_readings, slice=slice_results), f, indent=1)
    log("kernels: " + ", ".join(f"{k['name']} ok ({k['launches']} launches)" for k in kernels) + f" [{card}]")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
