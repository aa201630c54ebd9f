"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the repository root with one card:  python3 chip_smoke.py

Phases, each on ``cuda``; any failure raises and the script exits non-zero:

1. device: name, and name + power limit from nvidia-smi;
2. kernels: builds the CUDA sources from ``torchmx_tpu_torch/csrc``
   and holds each kernel against its plain PyTorch version on the card (K1/K2
   bit-exact over all 2^16 bf16 patterns in all five formats, and at every
   main-path shape; K3 over fp4 halves rel <= 1e-2 and on every (code,
   scale) pair bit for bit; K4 over fp8 and int8 caches, K5 over
   int8 caches, K6 over d-major fp8, int8, fp4 and fp6 caches and K7 over
   int8 d-major caches abs <= 2e-2, each at every main-path shape (K6 also
   at its KV chunks' boundaries, K5 and K7 at JAX's tiles' boundaries and K7
   at every GQA group, each row's relative L2 error under a gate, which a
   combine that drops the last live chunk or tile fails, and for K5 the
   whole output's too, which p rounded against its tile's own maximum
   fails); K6 against K4 on the same
   cache content, bit for bit on every row whose visible prefix lies in one
   chunk; K7's SQNR against exact attention above 30 dB (or, where its
   plain version, JAX's arithmetic, stays below, within 0.1 dB of it), its
   q codes (from its prologue) K1's bit for bit; this slice's B6 over four code formats and three act_fq values, B8
   over both fp6 formats and K3 over fp8 halves rel <= 1e-2 (K3-fp8 also on
   every (code, scale) pair bit for bit), B9 over int8 and int8-domain fp4 /
   e2m3 weights within one bf16 step and over e4m3 weights rel <= 1e-2 (at
   M = 1, 17, 32, 64, 65, 128, 129 and 256, lm_head at 1 and 32), K1's
   dot-order mode (B9's x) bit for bit over all 2^16 bf16 patterns and at
   B9's shapes, each at the five Llama-3-8B linears at every main-path M (B6
   also at 1-2048 rows across its tile edges, at K = 64 and 128, and on every
   (code, scale) pair bit for bit), and B9 giving B6's bytes on int8; B9
   timed as the path calls it and as its kernel, K1 and split reduce apart;
   the RMSNorm kernel within
   one bf16 step; B12 over bf16
   experts and four code formats at tm 8 and 128 rel <= 1e-2, each expert's
   rows bounded by the token count, on bench.py's shape routed-2 and spread,
   at Moonlight's decode b=32 and at the Mixtral and Moonlight main paths'
   w1 and w2 calls, dead and padding rows 0, giving B6's bytes for every live
   tile of code experts; the router kernel
   bit for bit; B13 over bf16, fp8, both fp6, int8 and fp4
   latent caches at the Moonlight paths' decode, admission and prefill
   shapes, bench.py's MLA decode shape and visible prefixes at and around
   its KV chunks' boundaries abs <= 2e-2 and each row's relative L2 error
   <= 1.2e-2, and over the int8
   cache against B13 bf16 over the dequantized latent; B14 over the int8
   d-major latent at its decode shapes and at its tiles' edges abs <= 2e-2
   and each row's relative L2 error <= 5e-3 (the dropped-tile fault
   failing it), SQNR > 30 dB against exact attention where its plain
   version reaches it, its prologue's q codes and scales the per-row
   kernel's; the per-row quantize kernel bit for bit over all 2^16 bf16
   patterns as rows of 512 and 64 in int8, fp8 and both fp6 formats, in both
   output modes, and at the q pair of B14's plain version and the d-major
   latent writes of the Moonlight path, with clamped starts; B7 (K3's
   kernel in the pair layout, x in even / odd K planes written by K2) at the
   shared-expert down shape and at K = 160, 896 and 4864 rel <= 1e-2, with
   act fq None, fp8 and int8, its pair decode on every (code, scale) pair bit
   for bit, and K2's plane mode bit for bit over all 2^16 bf16 patterns; the
   router's f32 mode bit for bit at E = 64 and 256; K4 over fp6 caches
   abs <= 2e-2; K5 and K7 at the GQA groups they run padded (3, 5, 6, 7;
   Qwen2-7B's 28 query heads over 4 KV heads at 7) at K7's decode cases
   under their gates, each failing them with its query heads read at the
   padded instance's stride, and timed at groups 7 and 8 over the same
   bytes; K4 and K6 at a group of 7 at decode and a whole admission of 384;
   every attention kernel at phase 10's ``generate`` shapes (a cache of
   256: decode at b=32 and b=1, a prefill of 32 x 64), K6 giving K4's
   bytes; the RMSNorm kernel at Qwen2's widths 896 and 3584 alone and fused,
   row by row), then
   times kernel, plain version and, where one exists, the one PyTorch call
   computing the same function (CUDA events, median of 20, L2 flushed
   before each call); every matmul kernel and the RMSNorm kernel must give a
   row the same bytes whatever the number of rows in the call, and B9 and
   B6 the same bytes for an int8 row; B12, the router kernel in both modes
   and B7 give every token the same bytes at every token count from 1 to
   511;
3. model check: a 2-layer model at Llama-3-8B width, seeded random weights,
   b=2, 16 greedy tokens, with the fp8 cache, the int8 cache and the int8
   d-major cache with the all-int8 decode flag (K6 and K7); then this slice's
   weight formats on models of their own: W8A8 over the int8 cache, MXFP6
   e3m2, MXFP8 and MXFP8-under-``TORCHMX_FP8_DOT`` weights over the fp8 cache
   (the last two faults on B9: K1 writing its x in natural order, and B9-fp8
   taking a block's weight scale from the next block).  At every step, from the same tokens and cache, kernel path against plain path on
   the same card: each decoder layer's update and lm_head's logits
   teacher-forced from the plain path's hidden state, the end-to-end logits
   (L2 rel, gates in GATES), and the tokens wherever the plain top-2 gap
   exceeds the cache's tie gap.  The plain path with another rounding
   (float64 attention, other tiles) must pass the same gates, and each
   planted kernel fault must fail one.  Then 2-layer Mixtral-8x7B-width
   models over the int8 seq cache (router rows 0 and 1 tied, so that the
   tie-break is exercised): fp4 grouped experts (B12 on int8-domain codes)
   with six planted faults (B12 on the wrong expert, B12 on the next
   block's scale row, inside B12's kernel W's row coordinate one MX block
   late and a live tile's row extent one row short, the router's tie-break
   reversed, combine dropping the second expert) and e3m2 grouped
   experts, the kernel path replaying the plain path's expert choices
   (``RouteTape``), a seventh fault flipping an expert choice at a probability gap above 5e-2; and the int8-weight
   grouped model against the per-expert one (B6), bit for bit.  Then
   2-layer models at Moonlight-16B-A3B width (layer 0 dense, layer 1 MoE,
   router rows 0 and 1 tied, random correction biases) over the int8 seq
   latent (B13, with ten planted faults: B13 on the next position's scale,
   B13 taking V from the rope key, B13's combine dropping the last live
   chunk of a tile, B7 with its nibbles swapped, B7 reading
   block 2j's scale for block 2j + 1, K2 writing B7's odd plane first, the
   correction bias in the weights, routed_scaling_factor dropped, the shared
   experts dropped, a routing flip above 5e-2), the fp4 seq latent, the bf16
   ``MLACache`` and the int8 d-major latent with the all-int8 flag (B14 and
   the per-row quantize kernel, with a planted fault: the latent written one
   position late), the kernels under the plain path's expert choices
   (``NoauxRouteTape``).  Last, 2-layer Qwen2 models with seeded nonzero
   q/k/v biases after a prompt of 320: at Qwen2-7B width over the fp8 seq,
   int8 seq (K5 at a group of 7) and int8 d-major all-int8 (K7) caches,
   with the k bias dropped, K5's / K7's padded-stride reads and one
   rounding fault a cache (K4's p against the sub-tile maximum, K5's
   against its tile's own maximum, K7's p codes rounded down) as planted
   faults, and at Qwen2-0.5B width over the int8 cache (head_dim 64: JAX's
   eager route on both paths, counted, no attention kernel; its float64
   floor the eager route in float64), each under gates set from its own
   readings;
4. the ``generate`` path: Llama-3-8B's width (8 of its 32 layers by default)
   with MXFP4 weights, MXFP8
   activations and an fp8 KV cache, built layer by layer from a seed,
   greedy generation of 128 tokens after a 64-token prompt at batch 1 and
   32.  The launch counts are set to 0 just before each timed ``generate``
   and read just after (prefill and per decode step from the same run).
   Then, outside that run: time to first token, the synchronised gap
   between tokens, and a torch.profiler window giving device time per
   decode step by kernel and the device's idle share;
5. the engine path: the same model served by ``DecodeEngine`` over an int8
   KV cache, 32 slots of 1024 positions, a seeded stream of 48 requests
   (prompts of 32-512 tokens, 64-128 new tokens, a shared 128-token prefix
   cached).  A request's tokens and log-probabilities must be the same bit
   for bit alone and among 31 others, admitted whole, in chunks of 128 or
   over the cached prefix; EOS, a stop sequence and a full cache must each
   end a request with the right reason; every decode step must launch K3,
   K2 (once each for o_proj, down_proj and lm_head: the norms before q/k/v
   and gate/up apply their shared K2 in the RMSNorm kernel's launch), K1
   (once a layer: K and V into the cache), K5 and the RMSNorm kernel as often
   as the depth says and K4 never.  On a 4-layer
   model the engine's streams must equal the plain path's at every decisive
   step.  Reports tok/s over the stream, the gap between ``step()``
   returns, admission latency, device time per step by kernel, the idle
   share and peak memory;
6. the d-major paths (``TORCHMX_KV_LAYOUT=dmajor``): the same engine stream
   and checks over the int8 d-major cache with ``TORCHMX_ATTN_INT8_DOT=1``
   (K6 serves admissions, K7, which quantizes q itself, every decode step),
   and ``generate`` at batch 32 over an fp4 d-major cache (K6
   at prefill and decode);
7. this slice's formats, each on a Llama-3-8B of its own: the engine stream
   and all its checks with MXINT8 weights and activations (W8A8) over the
   int8 cache (B9 at every decode step and at admissions of up to 256
   rows for o/down, B6 above: admissions cross 64 and 256 rows, and a row
   must keep its bytes), then ``generate`` at batch 32 over the fp8 cache
   with MXFP6 e3m2 weights (B8 throughout), MXFP8 weights (K3 over fp8
   halves) and MXFP8 weights under ``TORCHMX_FP8_DOT=1`` (B9-fp8 at decode,
   B6 at prefill);
8. Mixtral-8x7B (8 of its 32 layers, 8 experts, top-2) with MXFP4
   grouped experts (stacked int8-domain codes, B12), MXFP4 attention (K3),
   MXFP8 activations and the int8 seq cache, built layer by layer from a
   seed: ``generate`` at batch 1 and 32 (prompt 64 + 128 new) and the
   48-request engine stream with every check of phase 5; every decode step
   must launch B12 three times a layer;
9. the DeepSeek-V3 path: Moonlight-16B-A3B (8 of its 27 layers, 64 routed experts,
   top-6, 2 shared experts, DeepSeek-V3 MLA) with MXFP4 weights (grouped
   experts on int8-domain codes, B12; the shared experts' down_proj, K 2816,
   in the pair layout, B7 after its own K2), MXFP8 activations, the f32
   router and the int8
   seq latent cache (B13): ``generate`` at batch 1 and 32, the 48-request
   engine stream with every check of phase 5, then ``generate`` at batch 32
   over the int8 d-major latent with ``TORCHMX_ATTN_INT8_DOT=1`` (B14 at
   every decode step, quantizing its query itself, the per-row quantize
   kernel at every latent write, the plain quantizer raising if it meets a
   CUDA tensor);
   every decode step must launch each kernel as often as the model's
   structure says;
10. Qwen2-7B (8 of its 28 layers, ``QWEN2_LAYERS``, seeded q/k/v biases):
   ``generate`` at batch 1 and 32 over the fp8 cache, the 48-request engine
   stream over the int8 cache with every check of phase 5 (K5 at every decode
   step, K4 never), ``generate`` at batch 32 over the int8 d-major cache with
   the all-int8 flag (K7 at every decode step); then Qwen2-0.5B at all 24
   layers through ``generate`` at batch 1 and 32 over the int8 cache: B7 at
   every linear, no attention kernel, the eager attention route counted
   layers x 128 times a run and never on any other path.  Last, the engine against the plain path
   on a 4-layer Llama, a 2-layer Mixtral and a 4-layer Moonlight, the plain
   runs replaying the kernel runs' expert choices.

Every kernel must have launched on each main path that runs it.  The line
before last is a JSON object describing every kernel; the last is
``{"ok": true, "device": {...}}``.  The Llama models of phases 4-7 run 8
of Llama-3-8B's 32 layers (``--layers N`` sets another depth), Mixtral 8 of
its 32 and Moonlight 8 of its 27 (``MIXTRAL_LAYERS``, ``MOONLIGHT_LAYERS``;
``tools/paths_ab.py`` measures the paths at full depth).
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
# Depth of the models of phases 4-9 by default: Llama-3-8B-width models cut
# from 32 layers, Mixtral-8x7B from 32, Moonlight-16B-A3B from 27 (its first
# layer dense, the rest MoE), so that the whole script ends well inside its
# time limit on a slow host (PERF.md).
LLAMA_LAYERS = 8
MIXTRAL_LAYERS = 8
MOONLIGHT_LAYERS = 8
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


def bound(bytes_: float, ops: float = 0.0, peak: float = BF16_FLOPS):
    t_b, t_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
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
                                  (128256, 4096)],
                  # the engine's int8 cache: the decode step's write, a whole
                  # admission's and a chunk's
                  "int8": [(32, 8, 1, 128), (1, 8, 384, 128), (1, 8, 128, 128)]}
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
    for name, shapes in K1_MAIN_SHAPES.items():
        for shape in shapes:
            worst1 = max(worst1, compare(name, f"main-path {shape}", randn(shape), False)[0])
    # K1's dot-order mode (B9's x): every bf16 pattern as rows of 512, and
    # B9's decode and admission shapes.
    for name in cq.DOT_FORMATS:
        for label, x in (("all bf16 patterns (128, 512)", x_all.reshape(128, 512)),
                         ("all bf16 patterns, 17 rows", x_all.reshape(128, 512)[:17].contiguous()),
                         ("main-path (32, 4096)", randn((32, 4096))), ("main-path (256, 14336)", randn((256, 14336))),
                         ("main-path (1, 4096)", randn((1, 4096)))):
            s, c = cq.mx_quantize_dot(x, name)
            sp, cp = cq.mx_quantize_dot_plain(x, name)
            bad = int((s.view(torch.int32) != sp.view(torch.int32)).sum()) + int(
                (c.view(torch.uint8) != cp.view(torch.uint8)).sum())
            log(f"K1 mx_quantize in B9's dot order {name} {label}: {bad} mismatching scale factors / code bytes")
            if bad:
                raise AssertionError(f"K1's dot-order mode {name} {label}: differs from plain")
    for shape in K2_MAIN_SHAPES:
        x = randn(shape)
        fq, fp = cq.mx_fake_quantize_kernel(x, "float8_e4m3"), cq.mx_fake_quantize_plain(x, "float8_e4m3")
        err = max_abs_diff(fq, fp)
        log(f"K2 mx_fake_quantize float8_e4m3 main-path {shape}: max abs err {err}")
        if err != 0.0:
            raise AssertionError(f"K2 {shape}: differs from plain")
    # Timing at main-path shapes: K1 on the batch-32 prefill K write
    # (32, 8, 64, 128) and the decode step's int8 write and B9 x; K2 on the
    # batch-32 prefill activation (2048, 4096) and the b=32 decode one.  An
    # empty kernel (torch.cuda._sleep(0)) under the same timer gives the
    # launch floor the decode shapes sit on.
    floor = timer(lambda: torch.cuda._sleep(0))

    def timed(label, fn, plain, bytes_):
        row = dict(shape=label, ms=timer(fn), plain_ms=timer(plain, reps=5), bound_ms=bound(bytes_)[0],
                   bound_by="bytes", library_ms=None, empty_kernel_ms=floor)
        log("K1/K2 timing", json.dumps(row))
        return row

    k = torch.randn(32, 8, 64, 128, generator=gen, device=dev).to(torch.bfloat16)
    k1 = torch.randn(32, 8, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    a = torch.randn(2048, 4096, generator=gen, device=dev).to(torch.bfloat16)
    a32 = torch.randn(32, 4096, generator=gen, device=dev).to(torch.bfloat16)
    n, n1, na = k.numel(), k1.numel(), a32.numel()
    out = []
    int8_write = timed("int8 (32, 8, 1, 128)", lambda: cq.mx_quantize(k1, "int8"),
                       lambda: cq.mx_quantize_plain(k1, "int8"), 2 * n1 + n1 + n1 / 32)
    dot_decode = timed("int8 dot order (32, 4096)", lambda: cq.mx_quantize_dot(a32, "int8"),
                       lambda: cq.mx_quantize_dot_plain(a32, "int8"), 2 * na + na + 4 * na / 32)
    k2_decode = timed("fp8 (32, 4096)", lambda: cq.mx_fake_quantize_kernel(a32, "float8_e4m3"),
                      lambda: cq.mx_fake_quantize_plain(a32, "float8_e4m3"), 4 * na)
    t_b, by = bound(2 * n + n + n / 32)
    out.append(dict(name="mx_quantize", route="cuda", source="torchmx_tpu_torch/csrc/mx_quantize.cu",
                    replaces="torchmx_tpu/ops/pallas_quantize.py:137",
                    shape="fp8 (32, 8, 64, 128)", max_abs_err=worst1,
                    ms=timer(lambda: cq.mx_quantize(k, "float8_e4m3")),
                    plain_ms=timer(lambda: cq.mx_quantize_plain(k, "float8_e4m3"), reps=5),
                    bound_ms=t_b, bound_by=by, library_ms=None, int8_decode_write=int8_write,
                    dot_order_decode=dot_decode, empty_kernel_ms=floor))
    n = a.numel()
    t_b, by = bound(4 * n)
    out.append(dict(name="mx_fake_quantize", route="cuda", source="torchmx_tpu_torch/csrc/mx_quantize.cu",
                    replaces="torchmx_tpu/ops/pallas_quantize.py:217",
                    shape="fp8 (2048, 4096)", max_abs_err=worst2,
                    ms=timer(lambda: cq.mx_fake_quantize_kernel(a, "float8_e4m3")),
                    plain_ms=timer(lambda: cq.mx_fake_quantize_plain(a, "float8_e4m3"), reps=5),
                    bound_ms=t_b, bound_by=by, library_ms=None, decode=k2_decode, empty_kernel_ms=floor))
    return out


# The slice's projections as (K, N).  q/k/v and gate/up read an activation
# fake-quantized once by K2 (SHARED_FQ_LINEARS): at prefill (rows > 64) for
# every weight layout, at every M where the wrapper takes K2 first (K3's
# halves, B8's quarters); o_proj, down_proj and lm_head quantize their own.
# lm_head sees only the last position (M = batch).
K3_MAIN_LINEARS = {"q_proj/o_proj": (4096, 4096), "k_proj/v_proj": (4096, 1024),
                   "gate_proj/up_proj": (4096, 14336), "down_proj": (14336, 4096),
                   "lm_head": (4096, 128256)}
SHARED_FQ_LINEARS = {"q_proj/o_proj", "k_proj/v_proj", "gate_proj/up_proj"}


def k3_parts(timer, dev, x, w, elem, row):
    """A K3 timing row's parts, added to ``row``: the kernel alone on x
    quantized by K2, K2 on the call's x, the split reduce where the plan has
    a second pass, and the plan."""
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops.quantize import mx_fake_quantize

    M, K = x.shape
    plan = cm.plan_halves(M, w.shape[1], K, cm.sm_count(dev), elem)
    xq = mx_fake_quantize(x, "float8_e4m3")
    out, ws = cm.k3_kernel(xq, w.data, w.scale_e8m0, elem, plan)
    row.update(kernel_ms=timer(lambda: cm.k3_kernel(xq, w.data, w.scale_e8m0, elem, plan)),
               k2_ms=timer(lambda: mx_fake_quantize(x, "float8_e4m3")),
               reduce_ms=timer(lambda: cm.k3_reduce(ws, out, elem)) if ws is not None else None,
               plan=dict(splits=plan.splits, walk=plan.walk))
    log(f"K3 {elem} parts", json.dumps({k: row.get(k) for k in ("linear", "M", "act_fq", "case", "kernel_ms", "k2_ms",
                                                                 "reduce_ms", "plan")}))
    return row


def every_halves_pair(dev, elem):
    """Every (code, scale) pair of fp4 (16 x 256) or fp8 (256 x 256) in a
    (K = 256, N = 256) halves weight: code k % codes at row k, scale n in
    column n (:func:`every_code_scale_pair`).  Returns (payload, scales)."""
    fp4 = elem == "float4_e2m1"
    codes, scales = every_code_scale_pair(dev, 16 if fp4 else 256)
    if fp4:
        return ((codes[:128] << 4) | codes[128:]).to(torch.uint8).contiguous(), scales
    return ((codes[:128] << 8) | codes[128:]).to(torch.int16).view(torch.uint16).contiguous(), scales


def check_halves_decode(dev, elem):
    """Every (code, scale) pair through K3's decode, bit for bit: x the
    identity, so the output is the decoded weight (NaN as NaN); at M = 64
    (the first half's codes) and 256 (both halves)."""
    from torchmx_tpu_torch.ops import cuda_matmul as cm

    data, scales = every_halves_pair(dev, elem)
    fn, plain = ((cm.mx_matmul_fp4_halves, cm.mx_matmul_fp4_halves_plain) if elem == "float4_e2m1" else
                 (cm.mx_matmul_fp8_halves, cm.mx_matmul_fp8_halves_plain))
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    for M in (64, 256):
        x = eye[:M].contiguous()
        check_decode_bits(fn.__name__, elem, fn(x, data, scales), plain(x, data, scales))


def check_matmul_kernel(dev, timer, gen):
    """K3 over fp4 halves against its plain version (rel <= 1e-2) with and
    without act_fq at every main-path (M, K, N) and at M = 65 and 256; every
    (code, scale) pair through its decode bit for bit; then timed at every
    main-path call: the wrapper as the path calls it (K2 inside where the
    linear quantizes its own x), the plain version, ``torch.matmul`` on the
    bf16-dequantized weight, the bound, and apart the kernel alone, K2 and
    the split reduce.  Returns (entry, timing rows)."""
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

    # Every (M, K, N) the main path gives K3 (decode at batch 1 and 32,
    # prefill of 64 tokens at batch 1 and 32), and 65 and 256 rows, with and
    # without the activation quantize.
    for label, (K, N) in K3_MAIN_LINEARS.items():
        for M in (1, 32) if label == "lm_head" else (1, 32, 64, 65, 256, 2048):
            x = xs(M, K)
            for act in cm.ACT_FQ_FORMATS:
                check(x, label, act)
    check_halves_decode(dev, "float4_e2m1")
    # Timing at every main-path call; the JSON entry is the batch-32 decode
    # gate/up call (M=32, N=14336, K=4096, x quantized by the layer's K2).
    rows = []
    for label, (K, N) in K3_MAIN_LINEARS.items():
        w = weights[label]
        w_bf16 = cm.dequantize_fp4_halves(w.data, w.scale_e8m0)
        for M in (1, 32) if label == "lm_head" else FORMAT_MS:
            x = xs(M, K)
            act = _path_act(label, M, "float8_e4m3", first=True)
            t_b, by = bound(2 * M * K + K * N / 2 + K * N / 32 + 2 * M * N, 2 * M * N * K)
            row = dict(linear=label, M=M, N=N, K=K, act_fq=act,
                       ms=timer(lambda: cm.mx_matmul_fp4_halves(x, w.data, w.scale_e8m0, act)),
                       plain_ms=timer(lambda: cm.mx_matmul_fp4_halves_plain(x, w.data, w.scale_e8m0, act), reps=5),
                       library_ms=timer(lambda: torch.matmul(x, w_bf16)),
                       bound_ms=t_b, bound_by=by)
            k3_parts(timer, dev, x, w, "float4_e2m1", row)
            log("K3 timing", json.dumps(row))
            rows.append(row)
        del w_bf16
    pick = next(r for r in rows if r["M"] == 32 and r["N"] == 14336)
    return dict(name="mx_matmul_fp4_halves", route="cuda", source="torchmx_tpu_torch/csrc/mx_matmul.cu",
                replaces="torchmx_tpu/ops/pallas_matmul.py:504",
                shape="M=32 N=14336 K=4096 act_fq=None (x quantized by the layer's shared K2)", max_abs_err=worst,
                ms=pick["ms"], plain_ms=pick["plain_ms"], bound_ms=pick["bound_ms"],
                bound_by=pick["bound_by"], library_ms=pick["library_ms"]), rows


# The weight-format kernels (B6, B8, B9 and K3-fp8, as ROADMAP.md names them) at
# the main-path shapes: the five linears at M in (1, 32, 64, 2048), lm_head
# at 1 and 32; B9 (it takes M <= 256) at decode batches and admissions of up
# to 256 rows, across its row tile (128) and the 64-row switch of B6's
# activation quantize.
FORMAT_MS = (1, 32, 64, 2048)
B9_MS = (1, 17, 32, 64, 65, 128, 129, 256)
# B9-fp8's L2 rel against its plain version (exact block sums), the precision
# its design rests on: its in-block sums are mma.sync's f32 sums of exact
# products.  On an NVIDIA H100 80GB HBM3 (700 W) this build read at most
# 6.0e-5 over the 34 shapes of the check below (down_proj M=17), where a
# build on wgmma's e4m3 form read 4.2e-4 to 7.2e-4 at gate/up and down M=32;
# its max-abs rel, 3.2e-3 to 4.6e-3, passed the check's 1e-2.
B9_FP8_L2_REL_MAX = 1.5e-4
# B6 and B8 at every row count their callers give them (decode batches,
# admissions of 32-512 rows, 2048-row prefills), across the 64-row switch of
# the activation quantize and with ragged row tiles; B6 also at K = 64 and
# 128, fewer K steps than the stages of its async-copy ring (N = 4096 and
# 1024: a two-pass and a walked split plan at 2048 rows).
B6_MS = (1, 32, 64, 65, 128, 300, 512, 2047, 2048)
B6_SHORT_K = {"K=64": (64, 4096), "K=128": (128, 1024)}
ONE_BF16_STEP = "every element within one bf16 step of the plain version's"


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in units of b's bf16 step (of the smallest
    normal's near 0): 1 is one rounding apart."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126))) - 7)
    return ((a - b).abs() / ulp).max().item()


def _rel_max(o, r) -> float:
    return (o.float() - r.float()).abs().max().item() / r.float().abs().max().item()


def _path_act(label, M, act, first=False):
    """The activation format a linear's wrapper gets on the main path: q/k/v
    and gate/up read an activation fake-quantized once by K2 at prefill (M >
    64), and at every M where the wrapper takes K2 first (``first``: K3), so
    their wrapper runs without act_fq."""
    return None if ((first or M > 64) and label in SHARED_FQ_LINEARS) else act


class FormatBench:
    """The checks and timing rows of phase 2's weight-format kernels: each
    kernel against its plain version (rel <= 1e-2, or within one bf16 step),
    the worst abs error by kernel, and timing rows (kernel, plain version,
    ``torch.matmul`` on the bf16-dequantized weight, the bound)."""

    def __init__(self, dev, timer, gen):
        self.dev, self.timer, self.gen = dev, timer, gen
        self.worst = collections.defaultdict(float)  # max abs error by kernel
        self.rows = []

    def xs(self, M, K):
        return torch.randn(M, K, generator=self.gen, device=self.dev).to(torch.bfloat16)

    def check(self, name, label, M, what, out, ref, b9=False):
        err = bf16_steps(out, ref) if b9 else _rel_max(out, ref)
        self.worst[name] = max(self.worst[name], (out.float() - ref.float()).abs().max().item())
        log(f"{name} {label} M={M} {what}: {'bf16 steps' if b9 else 'rel err'} {err:.3e}")
        if not (err <= 1.0 if b9 else err <= 1e-2):
            raise AssertionError(f"{name} {label} M={M} {what}: {err}")

    def time_row(self, name, label, M, what, fn, plain, w_bf16, nbytes, ops, peak=BF16_FLOPS):
        t_b, by = bound(nbytes, ops, peak)
        row = dict(kernel=name, linear=label, M=M, K=w_bf16.shape[0], N=w_bf16.shape[1], case=what,
                   ms=self.timer(fn), plain_ms=self.timer(plain, reps=5), bound_ms=t_b, bound_by=by)
        x = self.xs(M, w_bf16.shape[0])
        row["library_ms"] = self.timer(lambda: torch.matmul(x, w_bf16))
        log(f"{name} timing", json.dumps(row))
        self.rows.append(row)
        return row

    def entry(self, name, source, replaces, pick):
        r = next(r for r in self.rows if r["kernel"] == name and pick(r))
        return dict(name=name, route="cuda", source=f"torchmx_tpu_torch/csrc/{source}", replaces=replaces,
                    shape=f"{r['linear']} M={r['M']} N={r['N']} K={r['K']} {r['case']}",
                    max_abs_err=self.worst[name],
                    tolerance=ONE_BF16_STEP if name == "mx_matmul_int8dot" else "rel <= 1e-2 (max abs over max abs)",
                    **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})


def every_code_scale_pair(dev, codes_per_row: int):
    """A (K = 256, N = 256) weight holding every (code, scale) pair: code k %
    codes_per_row at row k, scale n in column n; x the identity gives it
    back, bit for bit.  Returns (codes (K, N) int32, scales (8, N) uint8)."""
    codes = (torch.arange(256, device=dev, dtype=torch.int32) % codes_per_row).reshape(256, 1).expand(256, 256)
    scales = torch.arange(256, device=dev, dtype=torch.int32).reshape(1, 256).expand(8, 256).to(torch.uint8)
    return codes.contiguous(), scales.contiguous()


def check_decode_bits(name, e, o, r):
    differ = int(((o.view(torch.int16) != r.view(torch.int16)) & ~(o.isnan() & r.isnan())).sum())
    log(f"{name} {e}: every (code, scale) pair decoded at M={o.shape[0]}: {differ} of {o.numel()} differ")
    if differ:
        raise AssertionError(f"{name} {e} decodes {differ} (code, scale) pairs unlike its plain version")


# B8 at K = 128 and 256: fewer K steps than the stages of its ring (N = 4096
# and 1024: one split, and two splits walked or two-pass by M).
B8_SHORT_K = {"K=128": (128, 4096), "K=256": (256, 1024)}


def check_fp6q_kernel(dev, timer, gen, bench=None):
    """B8 against its plain version (rel <= 1e-2) over both fp6 formats and
    both act_fq values at the five Llama-3-8B linears and every M of B6_MS
    (lm_head at 1 and 32), and at K = 128 and 256; every (code, scale) pair
    through its decode bit for bit (x the identity); then timed at the P6
    path's calls at every M, the wrapper's call split into the kernel alone,
    K2 where the wrapper runs it first and the split reduce where the plan
    has a second pass, each beside the bound and ``torch.matmul``.  Returns
    (entry, timing rows)."""
    from torchmx_tpu_torch.mx_array import MXTensor
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops.quantize import mx_fake_quantize

    b = bench or FormatBench(dev, timer, gen)
    name = "mx_matmul_fp6q"

    def check_all(label, w, ms):
        K = w.shape[1]
        quarters = {e: MXTensor.to_mx(w, e).T.to_fp6_quarters() for e in kf.FP6_FORMATS}
        for M in ms:
            x = b.xs(M, K)
            for e, t in quarters.items():
                for act in kf.ACT_FQ_FP6Q:
                    b.check(name, label, M, f"{e} act_fq={act}", kf.mx_matmul_fp6q(x, t.data, t.scale_e8m0, e, act),
                            kf.mx_matmul_fp6q_plain(x, t.data, t.scale_e8m0, e, act))
        return quarters

    def time_b8(label, M, x, q, act, w_bf16):
        """A B8 timing row (the wrapper's call) and its parts: the kernel
        alone, K2 where the wrapper runs it first, the split reduce."""
        K, N = w_bf16.shape
        plan = kf.plan_fp6q(M, N, K, cm.sm_count(dev))
        xq = mx_fake_quantize(x, act) if act is not None else x
        out, ws = kf.b8_kernel(xq, q.data, q.scale_e8m0, "float6_e3m2", plan)
        kn = K * N
        row = b.time_row(name, label, M, f"float6_e3m2 act_fq={act}",
                         lambda: kf.mx_matmul_fp6q(x, q.data, q.scale_e8m0, "float6_e3m2", act),
                         lambda: kf.mx_matmul_fp6q_plain(x, q.data, q.scale_e8m0, "float6_e3m2", act),
                         w_bf16, 2 * M * K + 0.75 * kn + kn / 32 + 2 * M * N, 2 * M * N * K)
        row.update(kernel_ms=timer(lambda: kf.b8_kernel(xq, q.data, q.scale_e8m0, "float6_e3m2", plan)),
                   k2_ms=timer(lambda: mx_fake_quantize(x, act)) if act is not None else None,
                   reduce_ms=timer(lambda: kf.b8_reduce(ws, out)) if ws is not None else None,
                   plan=dict(splits=plan.splits, walk=plan.walk))
        for part in ("kernel_ms", "k2_ms", "reduce_ms"):
            log(f"{name} {part[:-3]}", json.dumps({k: row[k] for k in ("linear", "M", "case", part, "bound_ms",
                                                                      "bound_by", "library_ms", "plan")}))

    for label, (K, N) in K3_MAIN_LINEARS.items():
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        ms = (1, 32) if label == "lm_head" else B6_MS
        quarters = check_all(label, w, ms)
        w_bf16 = MXTensor.to_mx(w, "int8").T.to_dtype(torch.bfloat16)
        del w
        for M in ms:
            time_b8(label, M, b.xs(M, K), quarters["float6_e3m2"], _path_act(label, M, "float8_e4m3"), w_bf16)
        del quarters, w_bf16
        torch.cuda.empty_cache()
    for label, (K, N) in B8_SHORT_K.items():  # fewer K steps than ring stages
        check_all(f"{label} N={N}", (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16),
                  B6_MS)
    # Every (code, scale) pair through B8's rebuild and decode: each K
    # quarter holds codes 0..63 in every column, column n at scale n.
    codes, scales = every_code_scale_pair(dev, 64)
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    for e in kf.FP6_FORMATS:
        planes = MXTensor(scales, codes.to(torch.uint8), e, 32, block_dim=0).to_fp6_quarters().data
        for M in (64, 256):
            x = eye[:M].contiguous()
            check_decode_bits("mx_matmul_fp6q", e, kf.mx_matmul_fp6q(x, planes, scales, e),
                              kf.mx_matmul_fp6q_plain(x, planes, scales, e))
    entry = b.entry(name, "mx_matmul_fp6q.cu", "torchmx_tpu/ops/pallas_matmul.py:568",
                    lambda r: r["linear"] == "gate_proj/up_proj" and r["M"] == 32)
    return entry, [r for r in b.rows if r["kernel"] == name]


def check_format_kernels(dev, timer, gen):
    """B6 over its four code formats and three act_fq values, B8 (by
    :func:`check_fp6q_kernel`), B9 over int8, int8-domain fp4 and e2m3, and
    e4m3 weights, and K3 over fp8 halves, each against its plain version at
    every main-path shape (B6, B8, K3-fp8 rel <= 1e-2; B9 within one bf16
    step), K3-fp8 also at 65 and 256 rows; B6 also at every M of B6_MS and at
    K = 64 and 128; B6 and K3-fp8 on every (code, scale) pair bit for bit;
    then timed at the paths' calls: kernel,
    plain version, ``torch.matmul`` on the bf16-dequantized weight, and the
    bound (B9's operations at 1979 TOP/s dense int8 / fp8); B6 at every M of
    B6_MS and K3-fp8 at the path's, their kernel, K2 and split reduce apart.
    Returns (entries, timing rows)."""
    from torchmx_tpu_torch.mx_array import MXTensor
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops import cuda_quantize as cq
    from torchmx_tpu_torch.ops.cuda_quantize import mx_quantize
    from torchmx_tpu_torch.ops.quantize import mx_fake_quantize

    b = FormatBench(dev, timer, gen)
    xs, check, time_row = b.xs, b.check, b.time_row

    def time_b6(label, M, x, t, elem, act, w_bf16):
        """A B6 timing row: the wrapper's call (ms), and apart the kernel
        alone, K2 where the wrapper runs it first (act_fq above 64 rows)
        and the split reduce where the plan has a second pass."""
        K, N = w_bf16.shape
        plan = kf.plan_1byte(M, N, K, cm.sm_count(dev))
        fused = act if M <= kf.ACT_FQ_FUSE_MAX_M else None
        xq = mx_fake_quantize(x, act) if act is not None and fused is None else x
        out, ws = kf.b6_kernel(xq, t.data, t.scale_e8m0, elem, fused, plan)
        row = time_row("mx_matmul_1byte", label, M, f"{elem} act_fq={act}",
                       lambda: kf.mx_matmul_1byte(x, t.data, t.scale_e8m0, elem, act),
                       lambda: kf.mx_matmul_1byte_plain(x, t.data, t.scale_e8m0, elem, act),
                       w_bf16, 2 * M * K + K * N * (1 + 1 / 32) + 2 * M * N, 2 * M * N * K)
        row.update(kernel_ms=timer(lambda: kf.b6_kernel(xq, t.data, t.scale_e8m0, elem, fused, plan)),
                   k2_ms=timer(lambda: mx_fake_quantize(x, act)) if xq is not x else None,
                   reduce_ms=timer(lambda: kf.b6_reduce(ws, out)) if ws is not None else None,
                   plan=dict(splits=plan.splits, walk=plan.walk))
        log("mx_matmul_1byte parts", json.dumps({k: row[k] for k in ("linear", "M", "case", "kernel_ms", "k2_ms",
                                                                      "reduce_ms", "plan")}))

    def time_b9(label, M, x, t, fp8, w_bf16):
        """A B9 timing row (the wrapper's call: K1's dot-order mode, the
        kernel and the split reduce where the plan has a second pass), and
        the three apart."""
        K, N = w_bf16.shape
        fmt, name = ("float8_e4m3", "mx_matmul_fp8dot") if fp8 else ("int8", "mx_matmul_int8dot")
        plan = kf.plan_int8dot(M, N, K, cm.sm_count(dev))
        px_t, xd = cq.mx_quantize_dot(x, fmt)
        out, ws = kf.b9_kernel(xd, px_t, t.data, t.scale_e8m0, fp8, plan)
        row = time_row(name, label, M, f"{fmt}, x quantized by K1 inside the call",
                       lambda: kf.mx_matmul_int8dot(x, t.data, t.scale_e8m0, fp8),
                       lambda: _plain_int8dot(x, t, fp8), w_bf16, 2 * M * K + K * N * (1 + 1 / 32) + 2 * M * N,
                       2 * M * N * K, INT8_OPS)
        row.update(kernel_ms=timer(lambda: kf.b9_kernel(xd, px_t, t.data, t.scale_e8m0, fp8, plan)),
                   k1_ms=timer(lambda: cq.mx_quantize_dot(x, fmt)),
                   reduce_ms=timer(lambda: kf.b9_reduce(ws, out, fp8)) if ws is not None else None,
                   plan=dict(splits=plan.splits, walk=plan.walk))
        log(f"{name} parts", json.dumps({k: row[k] for k in ("linear", "M", "case", "kernel_ms", "k1_ms",
                                                              "reduce_ms", "plan")}))

    fp6q_entry, _ = check_fp6q_kernel(dev, timer, gen, b)
    for label, (K, N) in K3_MAIN_LINEARS.items():
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        flat = {e: MXTensor.to_mx(w, e).T for e in kf.CODE_FORMATS_1BYTE}
        halves = flat["float8_e4m3"].to_fp8_halves()
        int8dom = {"int8": flat["int8"], "float4_e2m1": MXTensor.to_mx(w, "float4_e2m1").T.to_int8_domain(),
                   "float6_e2m3": flat["float6_e2m3"].to_int8_domain()}
        del w
        ms = (1, 32) if label == "lm_head" else FORMAT_MS
        for M in B6_MS:
            x = xs(M, K)
            for e, t in flat.items():
                for act in kf.ACT_FQ_1BYTE:
                    check("mx_matmul_1byte", label, M, f"{e} act_fq={act}",
                          kf.mx_matmul_1byte(x, t.data, t.scale_e8m0, e, act),
                          kf.mx_matmul_1byte_plain(x, t.data, t.scale_e8m0, e, act))
        for M in (1, 32) if label == "lm_head" else (1, 32, 64, 65, 256, 2048):
            x = xs(M, K)
            for act in cm.ACT_FQ_FORMATS:
                check("mx_matmul_fp8_halves", label, M, f"act_fq={act}",
                      cm.mx_matmul_fp8_halves(x, halves.data, halves.scale_e8m0, act),
                      cm.mx_matmul_fp8_halves_plain(x, halves.data, halves.scale_e8m0, act))
        for M in ((1, 32) if label == "lm_head" else B9_MS):
            x = xs(M, K)
            for src, t in int8dom.items():
                sx, xc = mx_quantize(x, "int8")
                out = kf.mx_matmul_int8dot(x, t.data, t.scale_e8m0)
                check("mx_matmul_int8dot", label, M, f"{src} weights", out,
                      kf.mx_matmul_int8dot_plain(xc, sx, t.data, t.scale_e8m0), b9=True)
                if not torch.equal(out, kf.mx_matmul_1byte(x, t.data, t.scale_e8m0, "int8", "int8")):
                    raise AssertionError(f"B9 {label} M={M} {src}: not the bytes of B6 with int8 act_fq")
            t = flat["float8_e4m3"]
            sx, xc = mx_quantize(x, "float8_e4m3")
            out = kf.mx_matmul_int8dot(x, t.data, t.scale_e8m0, True)
            ref = kf.mx_matmul_int8dot_plain(xc, sx, t.data, t.scale_e8m0, True)
            l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
            log(f"mx_matmul_fp8dot {label} M={M}: {bf16_steps(out, ref):.3e} bf16 steps, L2 rel {l2:.3e} "
                f"(limit {B9_FP8_L2_REL_MAX:.1e})")
            check("mx_matmul_fp8dot", label, M, "e4m3 weights", out, ref)
            if not l2 <= B9_FP8_L2_REL_MAX:
                raise AssertionError(f"B9-fp8 {label} M={M}: L2 rel {l2:.3e} against its plain version "
                                     f"exceeds {B9_FP8_L2_REL_MAX:.1e}")
        # Timing at the paths' calls.
        w_bf16 = flat["int8"].to_dtype(torch.bfloat16)
        kn = K * N
        # B6 at the W8A8 and FP8_DOT prefills' calls (int8 and e4m3 codes,
        # the activation format each linear gets) and at every other M.
        for M in ((1, 32) if label == "lm_head" else B6_MS):
            x = xs(M, K)
            for e in ("int8", "float8_e4m3"):
                time_b6(label, M, x, flat[e], e, _path_act(label, M, e), w_bf16)
        for M in ms:
            x = xs(M, K)
            a8 = _path_act(label, M, "float8_e4m3", first=True)
            row = time_row("mx_matmul_fp8_halves", label, M, f"act_fq={a8}",
                           lambda: cm.mx_matmul_fp8_halves(x, halves.data, halves.scale_e8m0, a8),
                           lambda: cm.mx_matmul_fp8_halves_plain(x, halves.data, halves.scale_e8m0, a8),
                           w_bf16, 2 * M * K + kn + kn / 32 + 2 * M * N, 2 * M * N * K)
            k3_parts(timer, dev, x, halves, "float8_e4m3", row)
        for M in ((1, 32) if label == "lm_head" else B9_MS):
            x = xs(M, K)
            time_b9(label, M, x, flat["int8"], False, w_bf16)
            time_b9(label, M, x, flat["float8_e4m3"], True, w_bf16)
        del flat, halves, int8dom, w_bf16
        torch.cuda.empty_cache()
    # Every (code, scale) pair through B6's decode: x the identity, so the
    # output is the decoded weight, bit for bit (NaN as NaN), at both plans.
    codes, scales = every_code_scale_pair(dev, 256)
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    for e in kf.CODE_FORMATS_1BYTE:
        wc = codes.to(torch.uint8)
        wc = wc.view(torch.int8) if e == "int8" else wc
        for M in (64, 256):
            x = eye[:M].contiguous()
            check_decode_bits("mx_matmul_1byte", e, kf.mx_matmul_1byte(x, wc, scales, e),
                              kf.mx_matmul_1byte_plain(x, wc, scales, e))
    check_halves_decode(dev, "float8_e4m3")
    for label, (K, N) in B6_SHORT_K.items():  # fewer K steps than ring stages
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        for e in kf.CODE_FORMATS_1BYTE:
            t = MXTensor.to_mx(w, e).T
            for M in B6_MS:
                x = xs(M, K)
                for act in kf.ACT_FQ_1BYTE:
                    check("mx_matmul_1byte", f"{label} N={N}", M, f"{e} act_fq={act}",
                          kf.mx_matmul_1byte(x, t.data, t.scale_e8m0, e, act),
                          kf.mx_matmul_1byte_plain(x, t.data, t.scale_e8m0, e, act))

    decode_gate_up = lambda r: r["linear"] == "gate_proj/up_proj" and r["M"] == 32  # noqa: E731
    entries = [
        b.entry("mx_matmul_fp8_halves", "mx_matmul.cu", "torchmx_tpu/ops/pallas_matmul.py:504", decode_gate_up),
        b.entry("mx_matmul_1byte", "mx_matmul_1byte.cu", "torchmx_tpu/ops/pallas_matmul.py:419",
                lambda r: r["linear"] == "gate_proj/up_proj" and r["M"] == FORMAT_MS[-1]
                and r["case"].startswith("int8")),
        fp6q_entry,
        b.entry("mx_matmul_int8dot", "mx_matmul_int8dot.cu", "torchmx_tpu/ops/pallas_matmul.py:728", decode_gate_up),
        b.entry("mx_matmul_fp8dot", "mx_matmul_int8dot.cu", "torchmx_tpu/ops/pallas_matmul.py:728", decode_gate_up),
    ]
    return entries, b.rows


INT8_OPS = 1979e12  # dense int8 / fp8 tensor-core peak, data sheet


def _plain_int8dot(x, t, fp8):
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops.cuda_quantize import mx_quantize_plain

    sx, xc = mx_quantize_plain(x, "float8_e4m3" if fp8 else "int8")
    return kf.mx_matmul_int8dot_plain(xc, sx, t.data, t.scale_e8m0, fp8)


RMSNORM_SHAPES = ((1, 4096), (32, 4096), (2048, 4096))  # decode b=1, b=32, prefill b=32


def check_rmsnorm_kernel(dev, timer, gen):
    """The RMSNorm kernel against its plain version (at most one bf16 step:
    the fp32 sum of squares is taken in another order) at the main path's
    shapes, timed beside ``torch.nn.functional.rms_norm``."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_norm

    from torchmx_tpu_torch.ops import cuda_quantize as cq

    w = (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(torch.bfloat16)
    worst, worst_abs, rows = 0.0, 0.0, []
    # The norm fused with K2: K2 of the kernel's own output, bit for bit, for
    # every activation format, at the main path's shapes and over every bf16
    # pattern as 16 rows of 4096 (infinities and NaNs among them).
    for label, x in [(f"{shape}", torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16) * 4)
                     for shape in RMSNORM_SHAPES] + [("all bf16 patterns (16, 4096)", all_bf16_blocks(dev).reshape(16, 4096))]:
        for act in ("float8_e4m3", "int8", "float6_e3m2", "float6_e2m3", "float4_e2m1"):
            fused, want = cuda_norm.rms_norm(x, w, 1e-5, act), cq.mx_fake_quantize_kernel(cuda_norm.rms_norm(x, w, 1e-5), act)
            nan = torch.isnan(fused.float()) & torch.isnan(want.float())
            bad = int(((fused.view(torch.int16) != want.view(torch.int16)) & ~nan).sum())
            if bad:
                raise AssertionError(f"mx_rmsnorm fused with K2 {act} {label}: {bad} values differ from K2 of the norm")
        log(f"mx_rmsnorm fused with K2 {label}: K2 of the norm's output bit for bit in all five formats")
    for shape in RMSNORM_SHAPES:
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        out, ref = cuda_norm.rms_norm(x, w, 1e-5), cuda_norm.rms_norm_plain(x, w, 1e-5)
        steps = bf16_steps(out, ref)
        differ = int((out != ref).sum())
        worst, worst_abs = max(worst, steps), max(worst_abs, max_abs_diff(out, ref))
        log(f"mx_rmsnorm {shape}: {differ} of {out.numel()} values differ from the plain version's, "
            f"at most {steps:.3g} bf16 steps")
        if steps > 1.0:
            raise AssertionError(f"mx_rmsnorm {shape}: {steps} bf16 steps from the plain version")
        n = x.numel()
        t_b, by = bound(2 * n + 2 * n + 2 * 4096, 3 * n)
        row = dict(shape=shape, ms=timer(lambda: cuda_norm.rms_norm(x, w, 1e-5)),
                   plain_ms=timer(lambda: cuda_norm.rms_norm_plain(x, w, 1e-5), reps=5),
                   library_ms=timer(lambda: F.rms_norm(x, (4096,), w, 1e-5)), bound_ms=t_b, bound_by=by,
                   values_differing=differ, bf16_steps=steps,
                   fused_fp8_ms=timer(lambda: cuda_norm.rms_norm(x, w, 1e-5, "float8_e4m3")),
                   norm_then_k2_ms=timer(lambda: cq.mx_fake_quantize_kernel(cuda_norm.rms_norm(x, w, 1e-5),
                                                                            "float8_e4m3")))
        log("mx_rmsnorm timing", json.dumps(row))
        rows.append(row)
    pick = rows[1]
    return dict(name="mx_rmsnorm", route="cuda", source="torchmx_tpu_torch/csrc/mx_rmsnorm.cu",
                replaces="torchmx_tpu/models/llama.py:521",
                repair="no TPU kernel: the JAX RMSNorm is plain jnp; this kernel repairs the port's row "
                       "invariance (PyTorch's fp32 mean sums 3-15 rows in another order)",
                shape="(32, 4096) decode b=32", max_abs_err=worst_abs, bf16_steps=worst, tolerance="one bf16 step",
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}), rows


def _attn_case(dev, gen, b, hq, hkv, d, L, sq, kv_len, elem="float8_e4m3", never_written=False):
    """Arguments of K4 for a random cache: row i's queries are the last
    ``sq`` of its ``kv_len[i]`` visible positions.  With ``never_written`` the
    codes and scales past each row's prefix are 0, as in a fresh cache."""
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    k = torch.randn(b, hkv, L, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, hkv, L, d, generator=gen, device=dev).to(torch.bfloat16)
    ks, kd = cq.mx_quantize(k, elem)
    vs, vd = cq.mx_quantize(v, elem)
    q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    if never_written:
        fresh = (torch.arange(L, device=dev) >= kv[:, None])[:, None, :, None]
        kd, ks, vd, vs = (t.masked_fill(fresh, 0) for t in (kd, ks, vd, vs))
    return (q, kd, ks, vd, vs, (kv - sq).clamp(min=0), kv, d ** -0.5, elem)


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
    code_bytes = d // 2 if args[8] == "float4_e2m1" else d
    for i in range(b):
        nbytes += 2 * hkv * min(kv_len[i], q_off[i] + sq) * (code_bytes + d // 32)
        visible = sum(min(q_off[i] + j + 1, kv_len[i]) for j in range(sq))
        ops += 4 * hq * d * visible
    return nbytes, ops


def _sdpa_inputs(args):
    """The dequantized cache and the boolean mask for the one PyTorch call
    that computes the same attention (the library yardstick)."""
    from torchmx_tpu_torch.mx_array import dequantize_mx

    q, kd, ks, vd, vs, q_off, kv_len, _, elem = args
    k = dequantize_mx(kd, ks, elem, 32, torch.bfloat16, 3)
    v = dequantize_mx(vd, vs, elem, 32, torch.bfloat16, 3)
    pos = q_off[:, None] + torch.arange(q.shape[2], device=q.device)[None]
    j = torch.arange(kd.shape[2], device=q.device)
    mask = ((j <= pos[..., None]) & (j < kv_len[:, None, None]))[:, None]
    return k, v, mask


# K4 and K6 (one cluster kernel, csrc/mx_attention_tile.cuh) against their plain versions at
# JAX's tile, beside abs <= 2e-2: the worst row's relative L2 error, which a dropped last share
# fails, and the whole output's, which p rounded against the 64-position running maximum (the
# repaired fault C.1) fails: a rounding-level fault, in every row that spans a JAX tile's
# sub-tiles, whose worst row (>= 2.56e-3) stays below a sound kernel's.  From
# tools/gate_readings.py --kernel k4 / k6 --seeds 5 on an NVIDIA H100 80GB HBM3 at 700 W: K4
# sound row <= 3.94e-3, whole <= 2.68e-4, abs <= 7.8e-3; dropped share row >= 3.06e-2; sub-tile
# maximum whole >= 1.86e-3; K6 sound 3.87e-3 / 2.72e-4, dropped share >= 4.19e-2, sub-tile
# maximum whole >= 1.89e-3 (PERF.md rows 4 and 10).
K4_ROW_REL = 1.2e-2
K4_L2_REL = 7e-4
K6_ROW_REL = 1.2e-2
K6_L2_REL = 7e-4


def k46_readings(out, ref, layout="seq") -> tuple:
    """(max abs error, worst row's relative L2 error, whole output's relative
    L2 error) of K4's (or K6's) output against its plain version's, and
    whether they pass its gate."""
    row_gate, l2_gate = (K4_ROW_REL, K4_L2_REL) if layout == "seq" else (K6_ROW_REL, K6_L2_REL)
    err, rel, l2 = (out.float() - ref.float()).abs().max().item(), worst_row_rel(out, ref), _rel(out, ref)
    return err, rel, l2, err <= 2e-2 and rel <= row_gate and l2 <= l2_gate


def k46_fault_probes():
    """(L, sq, kv_len, fault) of one batch row alone where K4's and K6's
    planted faults must fail the gate: the dropped last share holding one
    position (kv_len = P + 1, 2P + 1, P = attention_share(L)) and p rounded
    against the 64-position running maximum over JAX tiles of several
    sub-tiles (kv_len = lt, L), at L = 1024 (P 256, lt 512; decode and a
    prefill of 64), 8192 (P 1024, lt 2048) and 32768 (P 4096, two chunks of
    scores a share)."""
    from torchmx_tpu_torch.ops.cuda_attention import attention_share, attention_tile

    out = []
    for L, sqs in ((1024, (1, 64)), (8192, (1,)), (32768, (1,))):
        P, lt = attention_share(L), attention_tile(L)
        for sq in sqs:
            out += [(L, sq, kv, "drop_last_share") for kv in (P + 1, 2 * P + 1)]
            out += [(L, sq, kv, "p_from_sub_tile_max") for kv in (lt, L)]
    return out


def check_k46_faults(dev, gen, layout="seq", elem="int8"):
    """K4's (or K6's) planted faults at ``k46_fault_probes``: the sound kernel
    passes the gate (``k46_readings``), each fault fails it.  Returns the
    readings."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    fn, plain = ((ca.mx_cached_attention, ca.mx_cached_attention_plain) if layout == "seq" else
                 (ca.mx_cached_attention_dmajor, ca.mx_cached_attention_dmajor_plain))
    name, out = "K4" if layout == "seq" else "K6", []
    for L, sq, kv, fault in k46_fault_probes():
        args = _attn_case(dev, gen, 1, 32, 8, 128, L, sq, [kv], elem, never_written=True)
        args = args if layout == "seq" else _to_dmajor(args)
        ref = plain(*args)
        _, sound, sound_l2, ok = k46_readings(fn(*args), ref, layout)
        fault_abs, fault_rel, fault_l2, caught = k46_readings(fn(*args, **{fault: True}), ref, layout)
        log(f"{name} fault {fault} L={L} sq={sq} kv={kv}: row / whole rel L2 sound {sound:.3e} / {sound_l2:.3e}, "
            f"fault {fault_rel:.3e} / {fault_l2:.3e} (abs {fault_abs:.3e})")
        if not ok or caught:
            raise AssertionError(f"{name} {fault} L={L} sq={sq} kv={kv}: the gate must pass the kernel ({sound}, "
                                 f"{sound_l2}) and fail the fault (abs {fault_abs}, row rel {fault_rel}, whole "
                                 f"{fault_l2})")
        out.append(dict(L=L, sq=sq, kv_len=kv, fault=fault, sound_row_rel=sound, sound_l2=sound_l2,
                        fault_abs=fault_abs, fault_row_rel=fault_rel, fault_l2=fault_l2))
    return out


def check_k4_case(label, args):
    """K4 against its plain version under its gate, finite, 0 for a row that
    sees no key, the same bytes on a second launch.  Returns (abs, row rel,
    whole rel)."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    out = ca.mx_cached_attention(*args)
    torch.cuda.synchronize()
    err, rel, l2, ok = k46_readings(out, ca.mx_cached_attention_plain(*args))
    log(f"K4 mx_cached_attention {label}: max abs err {err:.3e}, row / whole rel L2 {rel:.3e} / {l2:.3e} vs plain "
        f"at JAX's tile")
    if not ok or not torch.isfinite(out.float()).all():
        raise AssertionError(f"K4 {label}: abs err {err}, row / whole rel L2 {rel} / {l2}")
    empty = [i for i, n in enumerate(args[6].tolist()) if n == 0]
    if empty and out[empty].float().abs().max().item() != 0.0:
        raise AssertionError(f"K4 {label}: a row with no visible key must output 0")
    if not torch.equal(out, ca.mx_cached_attention(*args)):
        raise AssertionError(f"K4 {label}: two launches on the same inputs differ")
    return err, rel, l2


def check_attention_kernel(dev, timer, gen):
    """K4 over fp8 seq caches at the main path's shapes and at K6's (and K7's)
    decode shapes against its plain version at JAX's tile under its gate
    (``check_k4_case``), timed with SDPA beside it; its planted faults caught
    by the gate.  Returns (K4's entry, timing rows)."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_attention as ca

    worst = dict(abs=0.0, row=0.0, l2=0.0)
    rows = []
    # hq=32, hkv=8, d=128 throughout.  A ragged batch over a long cache, then
    # the main path's calls: prefill of 64 tokens and decode over a cache of
    # 256 positions (64 + 128 rounded up to 128) at batch 1 and 32; then the
    # engine's ragged decode over 1024 positions, one row alone and a long
    # cache, the prefixes never written past (K6's and K7's decode cases).
    cases = [("ragged b=4 L=1024 sq=64", 4, 1024, 64, [1024, 777, 300, 70], False),
             ("ragged b=4 L=1024 sq=1", 4, 1024, 1, [1024, 777, 300, 70], False),
             ("decode b=32 L=256 kv=192", 32, 256, 1, [192] * 32, False),
             ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32, False),
             ("decode b=1 L=256 kv=192", 1, 256, 1, [192], False),
             ("prefill b=1 L=256 sq=64", 1, 256, 64, [64], False)]
    cases += [(label, b, L, 1, kv, True) for label, b, L, kv in K7_CASES]
    for label, b, L, sq, kv, fresh in cases:
        args = _attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, never_written=fresh)
        q, scale = args[0], args[7]
        err, rel, l2 = check_k4_case(label, args)
        worst = dict(abs=max(worst["abs"], err), row=max(worst["row"], rel), l2=max(worst["l2"], l2))
        k, v, mask = _sdpa_inputs(args)
        nbytes, ops = _attn_work(args)
        t_b, by = bound(nbytes, ops)
        row = dict(case=label, ms=timer(lambda: ca.mx_cached_attention(*args)),
                   plain_ms=timer(lambda: ca.mx_cached_attention_plain(*args), reps=5),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)),
                   bound_ms=t_b, bound_by=by, max_abs_err=err, worst_row_rel=rel, rel_l2=l2)
        log("K4 timing", json.dumps(row))
        rows.append(row)
        del k, v, mask
    faults = check_k46_faults(dev, gen, "seq")
    pick = rows[2]
    return dict(name="mx_cached_attention", route="cuda", source="torchmx_tpu_torch/csrc/mx_attention.cu",
                replaces="torchmx_tpu/ops/pallas_attention.py:115",
                shape="decode b=32 hq=32 hkv=8 d=128 L=256 kv_len=192 fp8 cache", max_abs_err=worst["abs"],
                worst_row_rel=worst["row"], row_rel_gate=K4_ROW_REL, rel_l2=worst["l2"], rel_l2_gate=K4_L2_REL,
                faults=faults, ms=pick["ms"], plain_ms=pick["plain_ms"], bound_ms=pick["bound_ms"],
                bound_by=pick["bound_by"], library_ms=pick["library_ms"]), rows


# K5 against its plain version, beside abs <= 2e-2: the worst row's relative L2 error, which a
# dropped tile fails, and the whole output's (8 rows or more), which p rounded against its
# tile's own maximum fails: a rounding-level fault, near a sound row's bf16 rounding but in
# every row.  From tools/gate_readings.py --kernel k5 --seeds 5 on an NVIDIA H100 80GB HBM3 at
# 700 W: sound row <= 1.94e-3 and whole <= 1.39e-4; dropped tile row >= 3.18e-2; own maximum
# whole >= 1.50e-3 (PERF.md row 5).
K5_ROW_REL = 8e-3
K5_L2_REL = 5e-4


def k5_readings(out, ref) -> tuple:
    """(max abs error, worst row's relative L2 error, whole output's relative
    L2 error) of K5's output against its plain version's, and whether they
    pass K5's gate."""
    err, rel, l2 = (out.float() - ref.float()).abs().max().item(), worst_row_rel(out, ref), _rel(out, ref)
    return err, rel, l2, err <= 2e-2 and rel <= K5_ROW_REL and l2 <= K5_L2_REL


def k5_fault_probes():
    """(L, kv_len, fault) of one batch row alone where K5's planted faults
    must fail the gate: the dropped last tile holding one position
    (kv_len = lt + 1, 2 lt + 1), and p rounded against its tile's own
    maximum over two and more whole tiles (kv_len = 2 lt, L), at L = 1024
    (lt 512), 1152 (lt 128, shares of four tiles: both faults inside a share
    too) and 8192 (lt 2048)."""
    from torchmx_tpu_torch.ops.cuda_attention import attention_tile

    out = []
    for L in (1024, 1152, 8192):
        lt = attention_tile(L)
        out += [(L, kv, "drop_last_tile") for kv in (lt + 1, 2 * lt + 1)]
        out += [(L, kv, "p_from_own_tile_max") for kv in sorted({2 * lt, L})]
    return out


def check_k5_faults(dev, gen):
    """K5's planted faults at ``k5_fault_probes``: the sound kernel passes
    the gate (``k5_readings``), each fault fails it.  Returns the readings."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    out = []
    for L, kv, fault in k5_fault_probes():
        args = _attn_case(dev, gen, 1, 32, 8, 128, L, 1, [kv], "int8", never_written=True)[:8]
        ref = ca.mx_cached_attention_chunkdot_plain(*args)
        _, sound, sound_l2, ok = k5_readings(ca.mx_cached_attention_chunkdot(*args), ref)
        bad = ca.mx_cached_attention_chunkdot(*args, **{fault: True})
        fault_abs, fault_rel, fault_l2, caught = k5_readings(bad, ref)
        log(f"K5 fault {fault} L={L} kv={kv}: row / whole rel L2 sound {sound:.3e} / {sound_l2:.3e}, fault "
            f"{fault_rel:.3e} / {fault_l2:.3e} (abs {fault_abs:.3e})")
        if not ok or caught:
            raise AssertionError(f"K5 {fault} L={L} kv={kv}: the gate must pass the kernel ({sound}, {sound_l2}) and "
                                 f"fail the fault (abs {fault_abs}, row rel {fault_rel}, whole {fault_l2})")
        out.append(dict(L=L, kv_len=kv, fault=fault, sound_row_rel=sound, sound_l2=sound_l2, fault_abs=fault_abs,
                        fault_row_rel=fault_rel, fault_l2=fault_l2))
    return out


def check_int8_attention_kernels(dev, timer, gen):
    """K4 over an int8 cache at the engine's prefill and chunk shapes against
    its plain version under its gate (``check_k4_case``); K5 at its decode shapes (K7's) and at
    JAX's tiles' edges against its plain version (abs <= 2e-2 and the worst
    row's and the whole output's relative L2 errors <= K5_ROW_REL and
    K5_L2_REL), its planted faults caught by the gate; K5 against K4-int8 on the same inputs is printed (the same
    function up to where p is rounded).  Returns (K5's entry, the timing
    rows, K4-int8's worst error)."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_attention as ca

    rows, worst4, worst5, worst5_rel, worst5_l2 = [], 0.0, 0.0, 0.0, 0.0
    # K4-int8: a whole 384-token admission, a 128-token chunk at offset 256, a
    # 64-token remainder after a 128-token prefix (all b=1 over the slot's
    # 1024 positions), and a batch-32 prefill of 64.
    k4_cases = [("int8 whole b=1 L=1024 sq=384", 1, 1024, 384, [384]),
                ("int8 chunk b=1 L=1024 sq=128 q_off=256", 1, 1024, 128, [384]),
                ("int8 remainder b=1 L=1024 sq=64 q_off=128", 1, 1024, 64, [192]),
                ("int8 prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32)]
    for label, b, L, sq, kv in k4_cases:
        args = _attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, "int8")
        err = check_k4_case(label, args)[0]
        worst4 = max(worst4, err)
        k, v, mask = _sdpa_inputs(args)
        nbytes, ops = _attn_work(args)
        t_b, by = bound(nbytes, ops)
        row = dict(case=label, kernel="mx_cached_attention", ms=timer(lambda: ca.mx_cached_attention(*args)),
                   plain_ms=timer(lambda: ca.mx_cached_attention_plain(*args), reps=5),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(
                       args[0], k, v, attn_mask=mask, scale=args[7], enable_gqa=True)),
                   bound_ms=t_b, bound_by=by)
        log("K4 timing", json.dumps(row))
        rows.append(row)
    # K5: the engine's decode step (b=32 over 1024 positions, every row at its
    # own length, one row with no visible key, the positions past each prefix
    # never written), one row alone, a long cache (K7's cases), the decode
    # over 1152 positions (9 tiles of 128: a CTA walks four), and JAX's tiles'
    # and K5's shares' edges.
    for label, b, L, kv in K5_CASES + k5_edge_cases():
        args = _attn_case(dev, gen, b, 32, 8, 128, L, 1, kv, "int8", never_written=True)
        a5 = args[:8]
        out = ca.mx_cached_attention_chunkdot(*a5)
        torch.cuda.synchronize()
        ref = ca.mx_cached_attention_chunkdot_plain(*a5)
        err, rel, l2, ok = k5_readings(out, ref)
        vs_k4 = (out.float() - ca.mx_cached_attention(*args).float()).abs().max().item()
        worst5, worst5_rel, worst5_l2 = max(worst5, err), max(worst5_rel, rel), max(worst5_l2, l2)
        empty = [i for i, n in enumerate(kv) if n == 0]
        log(f"K5 mx_cached_attention_chunkdot {label}: max abs err {err:.3e}, row / whole rel L2 {rel:.3e} / "
            f"{l2:.3e} vs plain at JAX's tile {ca.attention_tile(L)}, {vs_k4:.3e} vs K4-int8")
        if not ok or not torch.isfinite(out.float()).all():
            raise AssertionError(f"K5 {label}: abs err {err}, row / whole rel L2 {rel} / {l2}")
        if empty and out[empty].float().abs().max().item() != 0.0:
            raise AssertionError(f"K5 {label}: a row with no visible key must output 0")
        if not torch.equal(out, ca.mx_cached_attention_chunkdot(*a5)):
            raise AssertionError(f"K5 {label}: two launches on the same inputs differ")
        if (label, b, L, kv) not in K5_CASES:
            continue
        k, v, mask = _sdpa_inputs(args)
        nbytes, ops = _attn_work(args)
        t_b, by = bound(nbytes, ops)
        row = dict(case=label, kernel="mx_cached_attention_chunkdot",
                   ms=timer(lambda: ca.mx_cached_attention_chunkdot(*a5)),
                   k4_int8_ms=timer(lambda: ca.mx_cached_attention(*args)),
                   plain_ms=timer(lambda: ca.mx_cached_attention_chunkdot_plain(*a5), reps=5),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(
                       args[0], k, v, attn_mask=mask, scale=args[7], enable_gqa=True)),
                   bound_ms=t_b, bound_by=by, max_abs_err=err, worst_row_rel=rel, rel_l2=l2, max_abs_vs_k4_int8=vs_k4)
        log("K5 timing", json.dumps(row))
        rows.append(row)
        del k, v, mask
    faults = check_k5_faults(dev, gen)
    pick = next(r for r in rows if r["case"].startswith("decode b=32"))
    k5 = dict(name="mx_cached_attention_chunkdot", route="cuda",
              source="torchmx_tpu_torch/csrc/mx_attention_chunkdot.cu",
              replaces="torchmx_tpu/ops/pallas_attention.py:307",
              shape="decode b=32 hq=32 hkv=8 d=128 L=1024 kv_len 0..1024 ragged int8 cache",
              max_abs_err=worst5, worst_row_rel=worst5_rel, row_rel_gate=K5_ROW_REL, rel_l2=worst5_l2,
              rel_l2_gate=K5_L2_REL, faults=faults,
              ms=pick["ms"], plain_ms=pick["plain_ms"], bound_ms=pick["bound_ms"],
              bound_by=pick["bound_by"], library_ms=pick["library_ms"])
    return k5, rows, worst4


def _to_dmajor(args):
    """K4's arguments over a seq-layout cache (fp4 codes pair-packed, as K1
    writes them) as K6's over the d-major cache of the same content."""
    from torchmx_tpu_torch.packing import fp4_pairs_to_halves

    q, kd, ks, vd, vs, *rest = args
    if rest[-1] == "float4_e2m1":
        kd, vd = fp4_pairs_to_halves(kd), fp4_pairs_to_halves(vd)
    return (q, *(t.transpose(2, 3).contiguous() for t in (kd, ks, vd, vs)), *rest)


def worst_row_rel(x, ref) -> float:
    """The largest relative L2 error of a row (the last dimension) of x
    against ref; a row of ref that is all 0 must be matched exactly."""
    num = (x.double() - ref.double()).norm(dim=-1)
    return torch.where(num == 0, 0.0, num / ref.double().norm(dim=-1)).max().item()


def sqnr_db(x, exact) -> float:
    """Signal to noise of x against the exact result, over the rows that see a key."""
    keep = torch.isfinite(exact).all(-1)
    x, exact = x.double()[keep], exact[keep]
    return (10 * torch.log10(exact.square().sum() / (x - exact).square().sum())).item()


def _exact_attention(args):
    """Attention in float64 over the dequantized cache, p not rounded; rows
    that see no key are NaN."""
    q, sm_scale = args[0], args[7]
    k, v, mask = _sdpa_inputs(args)
    G = q.shape[1] // k.shape[1]
    s = (q.double() @ k.double().repeat_interleave(G, 1).transpose(-1, -2)) * sm_scale
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v.double().repeat_interleave(G, 1)


def k6_edge_cases():
    """K4's and K6's shares at and around their edges: over L = 1024 (P =
    attention_share(1024) = 256; JAX's tile 512), 384 and 1152 (JAX's tile
    128, shares of two tiles), at decode and in a prefill of 64; over L =
    16384 (shares of 2048, the most a CTA holds as scores) and 32768
    (shares of 4096, taken in two chunks of 2048) at decode, and at 32768 in
    a prefill of 64."""
    from torchmx_tpu_torch.ops.cuda_attention import attention_share

    P = attention_share(1024)
    edges = [P - 1, P, P + 1, 2 * P + 1]
    out = [("decode b=4 L=1024 kv=P-1,P,P+1,2P+1", 4, 1024, 1, edges, True),
           ("prefill b=4 sq=64 L=1024 kv=P-1,P,P+1,2P+1", 4, 1024, 64, edges, False)]
    for L, kv in ((384, [127, 128, 129, 257]), (1152, [128, 129, 257, 1152])):
        out += [(f"decode b=4 L={L} kv={','.join(map(str, kv))}", 4, L, 1, kv, True),
                (f"prefill b=4 sq=64 L={L} kv={','.join(map(str, kv))}", 4, L, 64, kv, False)]
    out += [("decode b=4 L=16384 kv=2048,2049,14337,16384", 4, 16384, 1, [2048, 2049, 14337, 16384], True),
            ("decode b=4 L=32768 kv=2049,4097,6145,32768", 4, 32768, 1, [2049, 4097, 6145, 32768], True),
            ("prefill b=2 sq=64 L=32768 kv=6145,32768", 2, 32768, 64, [6145, 32768], False)]
    return out


def check_k6_against_k4(out, k4, label):
    """K6 and K4 are one kernel in two layouts: on the same cache content
    their outputs are equal, bit for bit.  Returns the rows checked."""
    if not torch.equal(out, k4):
        raise AssertionError(f"K6 {label}: differs from K4 over the seq cache of the same content "
                             f"(abs {(out.float() - k4.float()).abs().max().item()})")
    return out.shape[0] * out.shape[1] * out.shape[2]


# K7 against its plain version: the worst row's relative L2 error, beside abs <= 2e-2 (set from
# tools/gate_readings.py --kernel k7 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md row 11).
K7_ROW_REL = 1.2e-2
RAGGED = [0] + [1 + (1023 * i) // 30 for i in range(31)]  # the engine's decode: kv_len 0 .. 1024
# K7's decode cases: label, b, L, kv_len of each row (q at kv_len - 1; the cache never written past it).
K7_CASES = [("decode b=32 L=1024 kv_len 0..1024 ragged", 32, 1024, RAGGED),
            ("decode b=1 L=1024 kv_len=700", 1, 1024, [700]),
            ("decode b=4 L=8192 kv_len=8192", 4, 8192, [8192] * 4)]


# K5's timed cases: K7's and the decode over a cache of 1152 positions (a
# slot the engine rounds up to 128 positions; JAX's tile 128, nine of them).
K5_CASES = K7_CASES + [("decode b=32 L=1152 kv_len 0..1152 ragged", 32, 1152,
                        [0] + [1 + (1151 * i) // 30 for i in range(31)])]


def k5_edge_cases():
    """K7's tile edges (K5 takes JAX's tiles too) and, at L = 1152 (nine
    tiles of 128, shares of four), the tiles' and the shares' edges."""
    edges = [127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 1151, 1152]
    return k7_edge_cases() + [(f"decode b={len(edges)} L=1152 lt=128 kv={','.join(map(str, edges))}",
                               len(edges), 1152, edges)]


def k7_edge_cases():
    """K7's and K5's tiles (lt = JAX's ``_pick_lt(L)``) at and around their
    edges, over L = 1024 (lt 512) and 8192 (lt 2048)."""
    from torchmx_tpu_torch.ops.cuda_attention import _pick_lt

    out = []
    for L in (1024, 8192):
        lt = _pick_lt(L)
        edges = [e for e in (lt - 1, lt, lt + 1, 2 * lt - 1, 2 * lt + 1, L) if e <= L]
        out.append((f"decode b={len(edges)} L={L} lt={lt} kv={','.join(map(str, edges))}", len(edges), L, edges))
    return out


def check_k7_dropped_tile(dev, gen):
    """The planted combine fault (the last live tile of a row dropped) at
    kv_len = lt + 1 and 2 lt + 1 over L = 1024 and 8192, one batch row
    alone: the sound kernel passes the row gate, the fault fails it.
    Returns the readings."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    out = []
    for L in (1024, 8192):
        lt = ca._pick_lt(L)
        for kv in (lt + 1, 2 * lt + 1):
            args = _to_dmajor(_attn_case(dev, gen, 1, 32, 8, 128, L, 1, [kv], "int8", never_written=True))[:8]
            ref = ca.mx_cached_attention_int8dot_plain(*args)
            sound = worst_row_rel(ca.mx_cached_attention_int8dot(*args), ref)
            fault = worst_row_rel(ca.mx_cached_attention_int8dot(*args, drop_last_tile=True), ref)
            log(f"K7 dropped-tile fault L={L} kv={kv}: worst row rel L2 sound {sound:.3e}, fault {fault:.3e}")
            if not sound <= K7_ROW_REL < fault:
                raise AssertionError(f"K7 L={L} kv={kv}: the row gate must pass the kernel ({sound}) and fail "
                                     f"the dropped tile ({fault})")
            out.append(dict(L=L, kv_len=kv, sound_row_rel=sound, fault_row_rel=fault))
    return out


def check_k7_q_codes(dev, gen):
    """K7's prologue quantizes q with K1's arithmetic: its codes and scales
    (through ``q_out``) equal ``quantize_q_int8``'s (K1 on the card) bit for
    bit, in every GQA group, over q holding zeros, subnormals and large
    values; the planted q-scale fault fails the row gate."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    for G in ca.KERNEL_GROUPS:
        args = _to_dmajor(_attn_case(dev, gen, 3, 2 * G, 2, 128, 1024, 1, [700, 1, 1024], "int8",
                                     never_written=True))[:8]
        q = args[0]
        q.view(-1)[::7] = 0
        q.view(-1)[1::11] *= 2.0 ** -120
        q.view(-1)[2::13] *= 2.0 ** 100
        want = ca.quantize_q_int8(q, 2)
        got = tuple(torch.empty_like(t) for t in want)
        ca.mx_cached_attention_int8dot(*args, q_out=got)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K7 G={G}: the prologue's q codes or scales differ from K1's")
    args = _to_dmajor(_attn_case(dev, gen, 4, 32, 8, 128, 1024, 1, [1, 300, 700, 1024], "int8",
                                 never_written=True))[:8]
    ref = ca.mx_cached_attention_int8dot_plain(*args)
    bad = ca.mx_cached_attention_int8dot(*args, q_scale_from_next_chunk=True)
    err, rel = (bad.float() - ref.float()).abs().max().item(), worst_row_rel(bad, ref)
    log(f"K7 prologue: q codes and scales equal K1's at G = {ca.KERNEL_GROUPS}; the q-scale fault reads abs "
        f"{err:.3e}, worst row rel L2 {rel:.3e}")
    if err <= 2e-2 and rel <= K7_ROW_REL:
        raise AssertionError("K7: the q-scale fault passes the gate")
    return dict(q_codes_equal_k1=True, q_scale_fault_abs=err, q_scale_fault_row_rel=rel)


def check_dmajor_attention_kernels(dev, timer, gen):
    """K6 over d-major fp8, int8 and fp4 caches at the main path's shapes (and
    fp6 at two of them) and at its share edges, in all five formats, against
    its plain version at JAX's tile (abs <= 2e-2 and the worst row's and the
    whole output's relative L2 errors <= K6_ROW_REL and K6_L2_REL) and, where
    K4 takes the format, against K4 over the seq cache of the same content,
    bit for bit (check_k6_against_k4); its planted faults caught by the
    gate; K7 at the engine's decode
    shapes and at its tiles' edges against its plain version (abs <= 2e-2
    and the worst row's relative L2 error <= K7_ROW_REL), with the
    dropped-tile fault caught by the row gate, and against exact float64
    attention (SQNR > 30 dB, or within 0.1 dB of its plain version's where
    that stays below), with K6's and K5's SQNR on the same inputs beside it;
    K7's q codes against K1's.  Returns (K6's entry, K7's entry,
    timing rows)."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_attention as ca

    ragged = RAGGED
    # label, b, L, sq, kv_len, never written past the prefix
    k6_cases = [("decode b=32 L=1024 kv_len 0..1024 ragged", 32, 1024, 1, ragged, True),
                ("decode b=1 L=1024 kv_len=700", 1, 1024, 1, [700], True),
                ("decode b=32 L=256 kv_len=192", 32, 256, 1, [192] * 32, False),
                ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32, False),
                ("whole b=1 L=1024 sq=384", 1, 1024, 384, [384], False),
                ("chunk b=1 L=1024 sq=128 q_off=256", 1, 1024, 128, [384], False)]
    edges = k6_edge_cases()
    rows, worst6, worst6_rel, worst6_l2, worst7 = [], 0.0, 0.0, 0.0, 0.0
    vs_k4 = dict(bit_equal_rows=0)
    for elem in ("float8_e4m3", "int8", "float4_e2m1", "float6_e3m2", "float6_e2m3"):
        fp6 = elem.startswith("float6")
        for label, b, L, sq, kv, fresh in (k6_cases[:1] + k6_cases[3:4] if fp6 else k6_cases) + edges:
            seq = _attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, elem, never_written=fresh)
            args = _to_dmajor(seq)
            out = ca.mx_cached_attention_dmajor(*args)
            torch.cuda.synchronize()
            ref = ca.mx_cached_attention_dmajor_plain(*args)
            err, rel, l2, ok = k46_readings(out, ref, "dmajor")
            worst6, worst6_rel, worst6_l2 = max(worst6, err), max(worst6_rel, rel), max(worst6_l2, l2)
            k4 = None
            if elem in ca.K4_FORMATS:
                k4 = dict(bit_equal_rows=check_k6_against_k4(out, ca.mx_cached_attention(*seq), f"{elem} {label}"))
                vs_k4["bit_equal_rows"] += k4["bit_equal_rows"]
            log(f"K6 mx_cached_attention_dmajor {elem} {label}: max abs err {err:.3e}, row / whole rel L2 {rel:.3e} "
                f"/ {l2:.3e} vs plain at JAX's tile; " + ("no K4 for this format" if k4 is None else
                                                         f"K4's bytes on all {k4['bit_equal_rows']} rows"))
            if not ok or not torch.isfinite(out.float()).all():
                raise AssertionError(f"K6 {elem} {label}: abs err {err}, row / whole rel L2 {rel} / {l2}")
            empty = [i for i, n in enumerate(kv) if n == 0]
            if empty and out[empty].float().abs().max().item() != 0.0:
                raise AssertionError(f"K6 {elem} {label}: a row with no visible key must output 0")
            if fp6 or (label, b, L, sq, kv, fresh) in edges:
                continue
            k, v, mask = _sdpa_inputs(seq)
            nbytes, ops = _attn_work(seq)
            t_b, by = bound(nbytes, ops)
            row = dict(case=f"{elem} {label}", kernel="mx_cached_attention_dmajor",
                       ms=timer(lambda: ca.mx_cached_attention_dmajor(*args)),
                       plain_ms=timer(lambda: ca.mx_cached_attention_dmajor_plain(*args), reps=5),
                       library_ms=timer(lambda: F.scaled_dot_product_attention(
                           args[0], k, v, attn_mask=mask, scale=args[7], enable_gqa=True)),
                       bound_ms=t_b, bound_by=by, max_abs_err=err, worst_row_rel=rel, rel_l2=l2, vs_k4=k4)
            if k4 is not None:
                row["k4_seq_ms"] = timer(lambda: ca.mx_cached_attention(*seq))
            log("K6 timing", json.dumps(row))
            rows.append(row)
            del k, v, mask
        # A cache nobody wrote to (codes and scales 0): every visible key is 0.
        blank = _to_dmajor(_attn_case(dev, gen, 2, 32, 8, 128, 256, 1, [0, 0], elem, never_written=True))
        out = ca.mx_cached_attention_dmajor(*blank[:5], torch.tensor([63, 0], dtype=torch.int32, device=dev),
                                            torch.tensor([64, 1], dtype=torch.int32, device=dev), *blank[7:])
        if out.float().abs().max().item() != 0.0:
            raise AssertionError(f"K6 {elem}: a never-written cache must give 0")
    faults6 = check_k46_faults(dev, gen, "dmajor")
    worst7_rel = 0.0
    for label, b, L, kv in K7_CASES + k7_edge_cases():
        seq = _attn_case(dev, gen, b, 32, 8, 128, L, 1, kv, "int8", never_written=True)
        args = _to_dmajor(seq)
        a7 = args[:8]
        out = ca.mx_cached_attention_int8dot(*a7)
        torch.cuda.synchronize()
        ref = ca.mx_cached_attention_int8dot_plain(*a7)
        err, rel = (out.float() - ref.float()).abs().max().item(), worst_row_rel(out, ref)
        worst7, worst7_rel = max(worst7, err), max(worst7_rel, rel)
        exact = _exact_attention(seq)
        sqnr = dict(k7=sqnr_db(out, exact), k7_plain=sqnr_db(ref, exact),
                    k6=sqnr_db(ca.mx_cached_attention_dmajor(*args), exact),
                    k5=sqnr_db(ca.mx_cached_attention_chunkdot(*seq[:8]), exact))
        log(f"K7 mx_cached_attention_int8dot {label}: max abs err {err:.3e}, worst row rel L2 {rel:.3e} vs plain "
            f"at JAX's tile {ca._pick_lt(L)}; SQNR against exact attention (dB): {json.dumps(sqnr)}")
        if not (err <= 2e-2 and rel <= K7_ROW_REL) or not torch.isfinite(out.float()).all():
            raise AssertionError(f"K7 {label}: abs err {err}, worst row rel L2 {rel}")
        # Above 30 dB (the JAX package's own bound for this path, tests/test_pallas_attention.py:243, at L =
        # 256); where JAX's arithmetic itself stays below it (the plain version, JAX's bit for bit on the CPU:
        # 28.8 dB at L = 8192, p requantized over tiles of 2048), within 0.1 dB of the plain version's.
        if not (sqnr["k7"] > 30 or sqnr["k7_plain"] <= 30 and sqnr["k7"] >= sqnr["k7_plain"] - 0.1):
            raise AssertionError(f"K7 {label}: SQNR {sqnr['k7']:.1f} dB against exact attention (plain "
                                 f"{sqnr['k7_plain']:.1f} dB)")
        empty = [i for i, n in enumerate(kv) if n == 0]
        if empty and out[empty].float().abs().max().item() != 0.0:
            raise AssertionError(f"K7 {label}: a row with no visible key must output 0")
        if not torch.equal(out, ca.mx_cached_attention_int8dot(*a7)):
            raise AssertionError(f"K7 {label}: two launches on the same inputs differ")
        del exact
        if (label, b, L, kv) not in K7_CASES:
            continue
        k, v, mask = _sdpa_inputs(seq)
        nbytes, ops = _attn_work(seq)
        t_b, by = bound(nbytes, ops)
        row = dict(case=f"int8 {label}", kernel="mx_cached_attention_int8dot",
                   ms=timer(lambda: ca.mx_cached_attention_int8dot(*a7)),  # q's quantization inside
                   k6_ms=timer(lambda: ca.mx_cached_attention_dmajor(*args)),
                   k5_seq_ms=timer(lambda: ca.mx_cached_attention_chunkdot(*seq[:8])),
                   plain_ms=timer(lambda: ca.mx_cached_attention_int8dot_plain(*a7), reps=5),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(
                       args[0], k, v, attn_mask=mask, scale=args[7], enable_gqa=True)),
                   bound_ms=t_b, bound_by=by, max_abs_err=err, worst_row_rel=rel, sqnr_db=sqnr)
        log("K7 timing", json.dumps(row))
        rows.append(row)
        del k, v, mask
    dropped7 = check_k7_dropped_tile(dev, gen)
    prologue = check_k7_q_codes(dev, gen)
    pick6 = next(r for r in rows if r["case"] == "float4_e2m1 decode b=32 L=256 kv_len=192")
    pick7 = next(r for r in rows if r["case"].startswith("int8 decode b=32") and r["kernel"].endswith("int8dot"))
    k6 = dict(name="mx_cached_attention_dmajor", route="cuda",
              source="torchmx_tpu_torch/csrc/mx_attention_dmajor.cu",
              replaces="torchmx_tpu/ops/pallas_attention.py:490",
              shape="decode b=32 hq=32 hkv=8 d=128 L=256 kv_len=192 fp4 d-major cache", max_abs_err=worst6,
              worst_row_rel=worst6_rel, row_rel_gate=K6_ROW_REL, rel_l2=worst6_l2, rel_l2_gate=K6_L2_REL,
              vs_k4=vs_k4, faults=faults6,
              **{key: pick6[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    k7 = dict(name="mx_cached_attention_int8dot", route="cuda",
              source="torchmx_tpu_torch/csrc/mx_attention_int8dot.cu",
              replaces="torchmx_tpu/ops/pallas_attention.py:638",
              shape="decode b=32 hq=32 hkv=8 d=128 L=1024 kv_len 0..1024 ragged int8 d-major cache (q quantized in "
                    "the kernel's prologue)", max_abs_err=worst7, worst_row_rel=worst7_rel, row_rel_gate=K7_ROW_REL,
              dropped_tile=dropped7, prologue=prologue,
              **{key: pick7[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return k6, k7, rows


CACHE_WRITES = (("int8", "seq"), ("int8", "dmajor"), ("float4_e2m1", "dmajor"), ("float8_e4m3", "seq"))


def check_cache_write(dev, timer, gen) -> dict:
    """``MXLayerKVCache.write`` on the card against the plain path's, bit for
    bit, in both layouts (a prompt of every bf16 pattern at an int position,
    then the engine's decode write: 32 rows, one token each at its own
    position, one of them clamped at the end), for int8, for fp4 in its
    d-halves packing and for fp8 in the seq layout: one K1 launch a write,
    K and V together, straight into the four buffers; and what the decode
    write costs: device ms and host us per call."""
    from torchmx_tpu_torch.models.llama import MXLayerKVCache
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.ops.backend import plain_path

    b, kv, L, d = 32, 8, 1024, 128
    every = all_bf16_blocks(dev).reshape(1, kv, 64, d)  # the 2^16 patterns as one batch row (kv, s, d)
    k0 = torch.cat([every.roll(i, dims=-1) for i in range(b)])  # each row all of them, in its own order
    v0 = k0.roll(1, dims=-1)
    k1, v1 = (torch.randn(b, kv, 1, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.randint(64, L, (b,), generator=gen, device=dev).int()
    pos[0] = L  # a draining slot: its start is clamped to L - 1
    out = {}
    for elem, layout in CACHE_WRITES:
        got = MXLayerKVCache.create(b, kv, L, d, elem, device=dev, layout=layout)
        ref = MXLayerKVCache.create(b, kv, L, d, elem, device=dev, layout=layout)
        for k, v, at in ((k0, v0, 0), (k1, v1, pos)):
            before, total = cuda_lib.LAUNCHES["mx_quantize"], sum(cuda_lib.LAUNCHES.values())
            got.write(k, v, at)
            if cuda_lib.LAUNCHES["mx_quantize"] != before + 1 or sum(cuda_lib.LAUNCHES.values()) != total + 1:
                raise AssertionError(f"cache write, {elem} {layout}: not one K1 launch")
            with plain_path():
                ref.write(k, v, at)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got.buffers, ref.buffers)):
            raise AssertionError(f"cache write, {elem} {layout}: the buffers differ from the plain path's")
        if any(max_abs_diff(x, y) for x, y in zip(got.dequantize(), ref.dequantize())):  # NaN blocks equal
            raise AssertionError(f"cache write, {elem} {layout}: dequantize() differs")
        n = 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            got.write(k1, v1, pos)
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        out[f"{elem} {layout}"] = dict(device_ms=timer(lambda: got.write(k1, v1, pos)), host_us_per_call=host_us)
    log(f"cache write (b=32, one token per row at per-row positions, L=1024): equal to the plain path's in both "
        f"layouts, int8, fp4 and fp8, one K1 launch a write; cost per call {json.dumps(out)}")
    return out


def check_row_invariance(dev) -> dict:
    """A row's result must not depend on how many rows share the call: the
    engine's whole = chunked = prefixed identity rests on it.  On the first k
    rows of a 512-row input against the same rows of the full call, bit for
    bit, on inputs from a generator of its own, at every count drawn: the
    RMSNorm kernel (16 draws), and at the four decoder linears K3 over fp4
    and fp8 halves, B6 over int8 (int8 act_fq) and fp8 codes, B8, and B9 int8
    and e4m3 up to 256 rows.  Then B9 against B6 with int8 act_fq and against
    B6 on the K2-quantized x (the W8A8 engine's two-pass prefill): the same
    bytes at every count up to 256, which is what lets a W8A8 row keep its
    bits whichever kernel its admission's size picks.  The plain RMSNorm's
    counts that differ (the fault the kernel repairs) are reported."""
    from torchmx_tpu_torch.models.llama import RMSNorm
    from torchmx_tpu_torch.mx_array import MXTensor
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops.backend import plain_path
    from torchmx_tpu_torch.ops.quantize import mx_fake_quantize

    gen = torch.Generator(dev).manual_seed(4321)
    counts = (1, 2, 3, 5, 8, 15, 16, 17, 33, 64, 65, 128, 129, 255, 256, 257, 300, 511)
    norm = RMSNorm(4096, 1e-5, dev)
    norm.weight.copy_((1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(torch.bfloat16))
    draws, plain_differs, bad = 16, collections.Counter(), []
    for _ in range(draws):
        x = torch.randn(512, 4096, generator=gen, device=dev).to(torch.bfloat16)
        full = norm(x)
        bad += [f"RMSNorm rows={k}" for k in counts if not torch.equal(norm(x[:k]), full[:k])]
        with plain_path():
            full = norm(x)
            plain_differs.update(k for k in counts if not torch.equal(norm(x[:k]), full[:k]))
    fp8 = "float8_e4m3"
    for label in ("q_proj/o_proj", "k_proj/v_proj", "gate_proj/up_proj", "down_proj"):
        K, N = K3_MAIN_LINEARS[label]
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        w4 = MXTensor.to_mx(w, "float4_e2m1").T.to_fp4_halves()
        w8 = MXTensor.to_mx(w, fp8).T
        w8h, wi = w8.to_fp8_halves(), MXTensor.to_mx(w, "int8").T
        wq = MXTensor.to_mx(w, "float6_e3m2").T.to_fp6_quarters()
        kernels = {
            "K3 fp4": lambda x: cm.mx_matmul_fp4_halves(x, w4.data, w4.scale_e8m0, fp8),
            "K3 fp8": lambda x: cm.mx_matmul_fp8_halves(x, w8h.data, w8h.scale_e8m0, fp8),
            "B6 int8": lambda x: kf.mx_matmul_1byte(x, wi.data, wi.scale_e8m0, "int8", "int8"),
            "B6 fp8": lambda x: kf.mx_matmul_1byte(x, w8.data, w8.scale_e8m0, fp8, fp8),
            "B8": lambda x: kf.mx_matmul_fp6q(x, wq.data, wq.scale_e8m0, "float6_e3m2", fp8),
            "B9 int8": lambda x: kf.mx_matmul_int8dot(x, wi.data, wi.scale_e8m0),
            "B9 e4m3": lambda x: kf.mx_matmul_int8dot(x, w8.data, w8.scale_e8m0, True),
        }
        xk = torch.randn(512, K, generator=gen, device=dev).to(torch.bfloat16)
        for name, fn in kernels.items():
            rows = 256 if name.startswith("B9") else 512
            full = fn(xk[:rows])
            bad += [f"{name} {label} rows={k}" for k in counts
                    if k <= rows and not torch.equal(fn(xk[:k].contiguous()), full[:k])]
        b6 = kernels["B6 int8"](xk)
        two_pass = kf.mx_matmul_1byte(mx_fake_quantize(xk, "int8"), wi.data, wi.scale_e8m0, "int8", None)
        if not torch.equal(two_pass, b6):
            bad.append(f"B6 int8 {label}: fused act_fq and the K2 two-pass form differ")
        bad += [f"B9 vs B6 int8 {label} rows={k}" for k in counts
                if k <= 256 and not torch.equal(kernels["B9 int8"](xk[:k].contiguous()), b6[:k])]
    if bad:
        raise AssertionError(f"a row's result depends on the number of rows or the kernel: {bad}")
    small = {k: n for k, n in sorted(plain_differs.items())}
    log(f"row invariance: the RMSNorm kernel ({draws} draws), K3 fp4 and fp8, B6 int8 and fp8, B8 (4 linears, "
        f"up to 511 rows) and B9 int8 and e4m3 (up to 256) give a row the same bytes at {counts}; B9 gives B6's "
        f"bytes (int8 act_fq and the K2 two-pass form) at every count up to 256; the plain RMSNorm differed at "
        f"(rows: draws) {json.dumps(small)}")
    return dict(counts=counts, draws=draws, plain_rmsnorm_differs=small)


def attention_accuracy(dev, gen) -> dict:
    """L2 rel error of every int8 decode-attention version against exact
    attention (float64, p not rounded) on the same cache: the kernels, their
    plain versions, K5's plain version in float64, and the bf16 rounding of
    the exact result alone.  They should err alike: the
    versions differ in where p is rounded, not in accuracy."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    args = _attn_case(dev, gen, 2, 32, 8, 128, 1024, 1, [70, 80], "int8", never_written=True)
    a5, exact = args[:8], _exact_attention(args)

    def rel(x):
        return ((x.double() - exact).norm() / exact.norm()).item()

    out = dict(k5=rel(ca.mx_cached_attention_chunkdot(*a5)), k5_plain=rel(ca.mx_cached_attention_chunkdot_plain(*a5)),
               k4_int8=rel(ca.mx_cached_attention(*args)), k4_int8_plain=rel(ca.mx_cached_attention_plain(*args)),
               bf16_of_exact=rel(exact.to(torch.bfloat16)))
    with f64_plain_attention():
        out["k5_plain_float64"] = rel(ca.mx_cached_attention_chunkdot_plain(*a5))
    log(f"int8 decode attention against exact attention, b=2 kv_len 70 and 80 (L2 rel): {json.dumps(out)}")
    if max(out.values()) > 2 * out["bf16_of_exact"]:
        raise AssertionError("an attention version errs more than twice the bf16 rounding of the exact result")
    return out


# -- phase 3 and 4: the model ----------------------------------------------------


def quant_configs(kv: str = "float8_e4m3", weights: str = "float4_e2m1", acts: str = "float8_e4m3"):
    """(attention config, MLP config, KV-cache config): fp4 weights and fp8
    activations unless told otherwise, and an fp8 (the ``generate`` path) or
    int8 (the engine's) cache."""
    from torchmx_tpu_torch.config import MXConfig, QAttentionConfig, QLinearConfig

    q = QLinearConfig(MXConfig(weights), MXConfig(acts))
    return QAttentionConfig(q), q, MXConfig(kv)


@contextlib.contextmanager
def env_knobs(**knobs):
    """Knobs of the port (``TORCHMX_FP8_DOT`` ...), set on its env module as a
    user's environment would set them; a weight-layout knob must be set while
    the model is built."""
    from torchmx_tpu_torch import env_variables as env

    old = {k: getattr(env, k) for k in knobs}
    for k, v in knobs.items():
        setattr(env, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(env, k, v)


# The weight configurations of this slice: name -> (weights, activations,
# KV cache, knobs).  The model check runs all four; `generate` at b=32 the
# last three; the W8A8 engine the first.
FORMATS = {"W8A8 int8 cache": ("int8", "int8", "int8", {}),
           "MXFP6 e3m2 fp8 cache": ("float6_e3m2", "float8_e4m3", "float8_e4m3", {}),
           "MXFP8 fp8 cache": ("float8_e4m3", "float8_e4m3", "float8_e4m3", {}),
           "MXFP8 FP8_DOT fp8 cache": ("float8_e4m3", "float8_e4m3", "float8_e4m3", {"TORCHMX_FP8_DOT": "1"})}


def kv_env(layout: str = "seq", int8dot: bool = False):
    """The cache layout new caches take and the all-int8 decode flag."""
    return env_knobs(TORCHMX_KV_LAYOUT=layout, TORCHMX_ATTN_INT8_DOT="1" if int8dot else "0")


# The caches the model check and the main paths run over: name -> (format,
# layout, all-int8 decode flag).
CACHES = {"float8_e4m3": ("float8_e4m3", "seq", False), "int8": ("int8", "seq", False),
          "int8 d-major int8dot": ("int8", "dmajor", True),
          "float4_e2m1 d-major": ("float4_e2m1", "dmajor", False)}


@contextlib.contextmanager
def f64_plain_attention():
    """The plain attention versions computed with another rounding, to measure
    how far the model alone carries such a difference: K4, K5 and K6 in
    float64 at JAX's tile (p rounded against the same running maxima, each
    in float64); B13's plain version in float64; JAX's eager route (head_dim
    64) in float64 with no bf16 rounding between its steps.  K7 and B14 keep
    their plain versions: their dots are exact integer sums, and p
    requantized in other groups than JAX's tile is a fault their kernels
    had, not another rounding of correct code."""
    import functools

    from torchmx_tpu_torch.models import llama
    from torchmx_tpu_torch.ops import cuda_attention as ca
    from torchmx_tpu_torch.ops import cuda_mla

    names = ("mx_cached_attention_plain", "mx_cached_attention_chunkdot_plain", "mx_cached_attention_dmajor_plain")
    plain = {n: getattr(ca, n) for n in names}
    mla, eager = cuda_mla.mx_mla_attention_plain, llama.cached_attention_eager
    for n in names:
        setattr(ca, n, functools.partial(plain[n], compute_dtype=torch.float64))
    cuda_mla.mx_mla_attention_plain = functools.partial(mla, compute_dtype=torch.float64)
    llama.cached_attention_eager = functools.partial(eager, compute_dtype=torch.float64)
    try:
        yield
    finally:
        for n, fn in plain.items():
            setattr(ca, n, fn)
        cuda_mla.mx_mla_attention_plain, llama.cached_attention_eager = mla, eager


# Wrong kernels the model check must catch, each emulated at its wrapper on
# the kernel path only (under plain_path() the wrapper is left alone).
PLANTED_FAULTS = ("K4 causal mask one position late", "K4 kv_len one short",
                  "K3 activation fq skipped", "K3 fp4 halves swapped",
                  "K3 reads the codes of stage t+1 with the scales of stage t",
                  "K2 shared by q/k/v and gate/up skipped")
# The same for the int8 cache, whose decode steps run K5.
PLANTED_FAULTS_INT8 = ("K5 kv_len one short", "K5 V scale of chunk c taken from chunk c+1",
                       "K4 kv_len one short")
# The same for the int8 d-major cache with the all-int8 flag: K7 at every
# decode step, K6 at prefill.
PLANTED_FAULTS_DMAJOR = ("K7 kv_len one short", "K7 V scale of chunk c taken from chunk c+1",
                         "K7 q scale of chunk c taken from chunk c+1", "K6 kv_len one short")
# The same for the fp4 d-major cache (F's), K6 at prefill and every decode
# step: the cluster kernel's two planted faults and a short kv_len.
PLANTED_FAULTS_FP4_DMAJOR = ("K6 combine drops the last live share", "K6 p rounded against the sub-tile maximum",
                             "K6 kv_len one short")
# The prompt length of the model check for each cache: F's is long enough
# that its decode steps see two shares of K6's cluster (L = 384: shares of
# 256), so that the dropped share shows.
CHECK_PROMPT = {"float4_e2m1 d-major": 320}


# The same for this slice's weight formats, one or two per new kernel.
PLANTED_FAULTS_FORMATS = {
    "W8A8 int8 cache": ("B9 weight scale of block b taken from block b+1", "B6 int8 weight scale one binade high",
                        "B6 reads the codes of K tile t+1 with the scales of tile t",
                        "K1 writes B9's x in natural order"),
    "MXFP6 e3m2 fp8 cache": ("B8 planes P1 and P2 swapped", "B8 decodes quarter 3 with quarter 2's scales"),
    "MXFP8 fp8 cache": ("K3-fp8 halves swapped",),
    "MXFP8 FP8_DOT fp8 cache": ("B9-fp8 weight scale of block b taken from block b+1",),
}


@contextlib.contextmanager
def planted_fault(name):
    from torchmx_tpu_torch.ops import cuda_attention as ca
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops.backend import on_cuda

    if name.startswith("B9"):
        mod, attr = kf, "mx_matmul_int8dot"
        orig = kf.mx_matmul_int8dot
        fp8_only = name.startswith("B9-fp8")  # the fault of the e4m3 variant alone

        def faulty(x, w, sw, fp8=False, xq=None):
            return orig(x, w, sw.roll(-1, dims=0) if on_cuda(x) and (fp8 or not fp8_only) else sw, fp8, xq)
    elif name.startswith("K1 writes B9's x"):
        from torchmx_tpu_torch.ops import cuda_quantize as cq

        mod, attr = kf, "mx_quantize_dot"  # the name B9's wrapper calls
        orig = kf.mx_quantize_dot

        def faulty(x, elem):
            px_t, codes = orig(x, elem)
            return px_t, (cq.from_dot_order(codes).contiguous() if on_cuda(x) else codes)
    elif name.startswith("B6"):
        mod, attr = kf, "mx_matmul_1byte"
        orig = kf.mx_matmul_1byte
        stale_stage = "K tile t+1" in name  # a ring slot read one stage late: the next 64 code rows

        def faulty(x, w, sw, elem, act_fq=None):
            if on_cuda(x) and elem == "int8":
                if stale_stage:
                    w = w.roll(-64, dims=0)
                else:
                    sw = sw + 1
            return orig(x, w, sw, elem, act_fq)
    elif name.startswith("B8"):
        mod, attr = kf, "mx_matmul_fp6q"
        orig = kf.mx_matmul_fp6q

        quarter3_scales = "quarter 3" in name  # the scale rows of the wrong quarter

        def faulty(x, planes, sw, elem, act_fq=None):
            if on_cuda(x):
                if quarter3_scales:
                    q = sw.shape[0] // 4
                    sw = torch.cat([sw[:3 * q], sw[2 * q:3 * q]])
                else:
                    q = planes.shape[0] // 3
                    planes = torch.cat([planes[:q], planes[2 * q:], planes[q:2 * q]])
            return orig(x, planes, sw, elem, act_fq)
    elif name.startswith("K2 shared"):  # the norm that applies it (RMSNorm's launch) leaves it out
        from torchmx_tpu_torch.models import llama

        mod, attr = llama, "rms_norm"
        orig = llama.rms_norm

        def faulty(x, w, eps, act=None):  # the layers' projections get the normed x unquantized
            return orig(x, w, eps, None if on_cuda(x) else act)
    elif name.startswith("K3-fp8"):
        mod, attr = cm, "mx_matmul_fp8_halves"
        orig = cm.mx_matmul_fp8_halves

        def faulty(x, w, sw, act_fq=None):
            if on_cuda(x):
                wi = w.view(torch.int16).to(torch.int32) & 0xFFFF
                w = (((wi & 0xFF) << 8) | (wi >> 8)).to(torch.int16).view(torch.uint16)
            return orig(x, w, sw, act_fq)
    elif name.startswith("K3 ") and "fq" not in name:
        mod, attr = cm, "mx_matmul_fp4_halves"
        orig = cm.mx_matmul_fp4_halves
        stale_stage = "stage t+1" in name  # a ring slot read one stage late: the next 64 packed rows

        def faulty(x, w, sw, act_fq=None):
            if on_cuda(x):
                w = w.roll(-64, dims=0) if stale_stage else ((w & 0xF) << 4) | (w >> 4)
            return orig(x, w, sw, act_fq)
    elif name.startswith("K7 q scale"):  # K7 quantizes q in its prologue: the fault is a launch argument
        mod, attr = ca, "mx_cached_attention_int8dot"
        orig = ca.mx_cached_attention_int8dot

        def faulty(q, *a, **kw):
            return orig(q, *a, q_scale_from_next_chunk=on_cuda(q), **kw)
    elif name.startswith(("K5", "K7")):
        k7 = name.startswith("K7")
        mod, attr = ca, "mx_cached_attention_int8dot" if k7 else "mx_cached_attention_chunkdot"
        orig = getattr(mod, attr)

        def faulty(q, kd, ks, vd, vs, q_off, kv_len, sm_scale):
            if on_cuda(q):
                if "kv_len" in name:
                    kv_len = kv_len - 1
                else:  # the chunks are the last axis in the seq layout, axis 2 in the d-major
                    vs = vs.roll(-1, dims=2 if k7 else -1)
            return orig(q, kd, ks, vd, vs, q_off, kv_len, sm_scale)
    elif name.startswith("K6 ") and "kv_len" not in name:  # the cluster kernel's own planted faults
        mod, attr = ca, "mx_cached_attention_dmajor"
        orig = ca.mx_cached_attention_dmajor
        kw_fault = "drop_last_share" if "drops" in name else "p_from_sub_tile_max"

        def faulty(q, *a, **kw):
            return orig(q, *a, **{**kw, kw_fault: on_cuda(q)})
    elif name.startswith(("K4", "K6")):
        mod, attr = ca, "mx_cached_attention" if name.startswith("K4") else "mx_cached_attention_dmajor"
        orig = getattr(mod, attr)

        def faulty(q, kd, ks, vd, vs, q_off, kv_len, *rest):
            if on_cuda(q):
                if "causal" in name:
                    q_off = q_off + 1
                else:
                    kv_len = kv_len - 1
            return orig(q, kd, ks, vd, vs, q_off, kv_len, *rest)
    else:
        mod, attr = cm, "mx_matmul_fp4_halves"
        orig = cm.mx_matmul_fp4_halves

        def faulty(x, w_data, w_scale, act_fq=None):
            return orig(x, w_data, w_scale, None if on_cuda(x) else act_fq)
    setattr(mod, attr, faulty)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def teacher_forced(model, ids, caches, pos, floor: bool, tape=None):
    """One step, layer by layer from the plain path's hidden state: each
    decoder layer's update (output minus input) on the kernel path, from a
    copy of the same cache, against the plain path's; then lm_head on the
    same final hidden state.  With ``floor``, also the plain path with
    float64 attention against the plain path, layer by layer.  Advances
    ``caches`` by the plain path.  With a ``RouteTape`` the plain layer
    records its routing and the other two replay it.  Returns (worst layer
    rel, lm_head rel, worst layer floor or None, plain logits of the last
    row)."""
    from torchmx_tpu_torch.models.llama import rope_cos_sin
    from torchmx_tpu_torch.ops.backend import plain_path

    m = model.model
    b, s = ids.shape
    x = m.embed_tokens[ids]
    position_ids = torch.arange(pos, pos + s, device=x.device)[None].expand(b, s)
    cos, sin = rope_cos_sin(m.inv_freq, position_ids, x.dtype)
    worst, worst_floor = 0.0, None
    def tape_mode(mode, who="kernel"):
        if tape is not None:
            tape.mode, tape.cursor, tape.who = mode, len(tape.routes) - 1, who

    for layer, cache in zip(m.layers, caches):
        kw = dict(cos=cos, sin=sin, cache_position=pos)
        pre, pre64 = cache.clone(), cache.clone() if floor else None
        tape_mode("record")
        with plain_path():
            ref = layer(x, cache=cache, **kw)
        tape_mode("replay")
        got = layer(x, cache=pre, **kw)
        if floor:
            tape_mode("replay", who="floor")
            with plain_path(), f64_plain_attention():
                ref64 = layer(x, cache=pre64, **kw)
        tape_mode(None)
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


def model_readings(model, prompt, n, kv, floor: bool, tie_gap: float) -> dict:
    """Greedy n tokens on the kernel path, then every step again from the
    same tokens and the same cache (the kernel path's, copied): end-to-end
    logits (L2 rel) kernel vs plain, the teacher-forced per-layer and lm_head
    readings, decisive-token disagreements, and (with ``floor``) the plain
    path against itself with float64 attention."""
    from torchmx_tpu_torch.models.generate import generate
    from torchmx_tpu_torch.ops.backend import plain_path

    tokens = generate(model, prompt, n, kv_cache_config=kv)
    caches = model.init_cache(prompt.shape[0], (prompt.shape[1] + n + 127) // 128 * 128, kv)  # generate's length
    r = dict(logits=0.0, layer=0.0, lm_head=0.0, floor_logits=None, floor_layer=None,
             near_ties=0, decisive_flips=0, max_flipped_gap=0.0,
             generate_mismatch=0, finite=True)
    step_in, pos = prompt, 0
    with torch.inference_mode():
        for i in range(n):
            snap = [c.clone() for c in caches]
            snap64 = [c.clone() for c in caches] if floor else None
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
            gap = top2[:, 0] - top2[:, 1]
            decisive, flipped = gap > tie_gap, got.argmax(-1) != ref.argmax(-1)
            r["near_ties"] += int((~decisive).sum())
            r["decisive_flips"] += int((flipped & decisive).sum())
            r["max_flipped_gap"] = max(r["max_flipped_gap"], float((gap * flipped).max()))
            r["generate_mismatch"] += int((got.argmax(-1) != tokens[:, i]).sum())
            r["finite"] &= bool(torch.isfinite(got).all())
            pos += step_in.shape[1]
            step_in = tokens[:, i:i + 1]
    return r


# Gates of the model check (L2 rel), each between the readings of sound
# code and the smallest reading of a planted fault (PERF.md, on the H100).
# Re-read when K4 and K6 (kernel and plain version) took JAX's
# tile and the float64 floors stopped taking K7 over tiles of 32 (NVIDIA
# H100 80GB HBM3, 700 W):
# fp8 cache: a teacher-forced decoder layer's update, sound 1.90e-2
# (kernels) and 3.21e-2 (plain path with float64 attention), faults >=
# 7.35e-2; lm_head, sound 1.6e-5, faults >= 3.02e-2; end-to-end logits, which
# carry the fp8 amplification of every rounding difference through both
# layers, sound 4.31e-2 and 6.51e-2, faults >= 9.16e-2.
# int8 cache: K5 rounds p against its plain version's running maxima at
# JAX's tile and K4 at prefill now does too, summing in another fp32 order
# than its plain version (the layer reading rose from 7.52e-5 to 2.52e-3:
# before, K4's kernel and plain version took the same 64-position tiles in
# the same order); the plain path with float64 attention against itself
# 1.60e-2 (layer) and 4.29e-2 (logits); the K5 faults >= 2.52e-1 (layer)
# and 2.57e-1 (logits), the K4 fault 2.03e-2 (layer) and 1.90e-1 (logits).
# The gates sit between the float64 readings, which are sound too, and the
# faults (the K4 fault caught by the logits).
# int8 d-major cache with the all-int8 flag: K6 gives K4's bytes and K7's
# integer dots are exact, so the kernels read the int8 cache's 2.52e-3
# (layer) and 3.15e-2 (logits); the plain path with float64 K6 (K7 as it
# is: its other rounding was p requantized over tiles of 32, a fault its
# kernel had) 2.46e-3 and 3.18e-2, was 7.11e-2 and 9.67e-2 over tiles
# of 32; K7 faults >= 3.00e-1 (layer), the K6 fault 1.90e-1 (logits).  Its
# gates move down to the int8 cache's, between those readings and the faults.
# tie_gap: a step counts as decisive when the plain path's top-2 logit gap
# exceeds it; the int8 path flips a gap of 0.125 with sound kernels.
GATES = {"float8_e4m3": {"layer": 5e-2, "lm_head": 2e-2, "logits": 8e-2, "tie_gap": 0.1},
         "int8": {"layer": 6e-2, "lm_head": 2e-2, "logits": 9e-2, "tie_gap": 0.3},
         "int8 d-major int8dot": {"layer": 6e-2, "lm_head": 2e-2, "logits": 9e-2, "tie_gap": 0.3},
         # fp4 d-major cache (F's): K6 at prefill and every decode step, after
         # a prompt of 320 tokens (two shares of 256 at L = 384).  On an H100
         # 80GB HBM3 (700 W), layer / logits: sound 2.46e-3 / 4.08e-2, the
         # plain path with float64 attention 1.58e-2 / 5.26e-2; faults: K6's
         # combine dropping the last live share 6.85e-1 / 7.04e-1, kv_len one
         # short 1.35e-1 / 1.58e-1, p rounded against the 64-position sub-tile
         # maximum 4.52e-2 / 7.83e-2, which passed the fp8 cache's layer gate
         # of 5e-2: the layer gate sits at 3e-2, between the float64 reading
         # and that fault; the logits gate stays the fp8 cache's.
         "float4_e2m1 d-major": {"layer": 3e-2, "lm_head": 2e-2, "logits": 8e-2, "tie_gap": 0.1},
         # The weight formats keep their cache's gates.  On an H100 80GB HBM3
         # (700 W), layer / logits: W8A8 sound 1.62e-2 / 2.27e-2 (B9's and B6's
         # int8 dots are exact), plain with float64 attention (K5 at JAX's
         # tile) 9.84e-3 / 1.76e-2, faults >= 1.16 / 1.06; MXFP6 2.17e-2 / 5.27e-2, 2.17e-2 / 4.82e-2,
         # fault 1.65 / 1.48; MXFP8 1.29e-2 / 4.99e-2, 2.32e-2 / 6.10e-2, fault
         # 1.73 / 1.52.
         "W8A8 int8 cache": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3},
         "MXFP6 e3m2 fp8 cache": {"layer": 5e-2, "lm_head": 2e-2, "logits": 8e-2, "tie_gap": 0.1},
         "MXFP8 fp8 cache": {"layer": 5e-2, "lm_head": 2e-2, "logits": 8e-2, "tie_gap": 0.1},
         # MXFP8 under TORCHMX_FP8_DOT=1 (B9-fp8 at decode and at prefill's
         # o/down, B6 at prefill's q/k/v and gate/up): the fp8 cache's layer,
         # lm_head and logits gates and the int8 cache's tie gap.  On an H100
         # 80GB HBM3 (700 W) the sound kernels read layer 2.39e-2 (the plain
         # path with float64 attention 2.32e-2), logits 4.86e-2, and flip a
         # token at a top-2 gap of 0.125, as the int8 path does, with B9-fp8
         # as close to the exact block sums as B6 is; the fault reads 1.13.
         "MXFP8 FP8_DOT fp8 cache": {"layer": 5e-2, "lm_head": 2e-2, "logits": 8e-2, "tie_gap": 0.3},
         # Mixtral over the int8 cache, kernels held under the plain path's
         # expert choices (RouteTape): the int8 cache's gates, no routing
         # decision may differ on the same logits, and the kernel path's own
         # choices may flip only where the plain path's k-th and (k+1)-th
         # expert probabilities lie within route_tie_gap.
         "Mixtral fp4 grouped int8 cache": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3,
                                            "route_tie_gap": 5e-2},
         "Mixtral e3m2 grouped int8 cache": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3,
                                             "route_tie_gap": 5e-2},
         # Moonlight-16B-A3B width (2 layers), the kernels held under the plain
         # path's expert choices (NoauxRouteTape); route_tie_gap bounds the gap
         # of the biased sigmoid choice values at an own flip.  The int8
         # cache's gates hold on the H100 (700 W), layer / logits: int8 seq
         # latent 1.30e-2 / 5.02e-2, plain with float64 attention 1.85e-2 /
         # 5.02e-2; fp4 3.6e-3 / 5.25e-2 and 2.83e-2 / 5.78e-2; bf16 2.35e-2 /
         # 5.45e-2 and 2.16e-2 / 5.35e-2; int8 d-major (B14, p requantized per
         # JAX tile since PR 18) 9.38e-3 / 2.73e-2 and (B14's plain version over
         # tiles of 32) 6.72e-2 / 9.96e-2; own routing flips at gaps <= 1.65e-2.  Faults: >= 3.41e-1 / 2.75e-1,
         # or (the bias in the weights, a flip above 5e-2) 284 and 2 routing
         # decisions that differ on the same scores.
         "Moonlight int8 seq latent": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3,
                                       "route_tie_gap": 5e-2},
         "Moonlight fp4 seq latent": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3,
                                      "route_tie_gap": 5e-2},
         "Moonlight bf16 MLACache": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3,
                                     "route_tie_gap": 5e-2},
         "Moonlight int8 d-major int8dot": {"layer": 1.3e-1, "lm_head": 2e-2, "logits": 1.2e-1, "tie_gap": 0.3,
                                            "route_tie_gap": 5e-2}}
# Qwen2 (2 layers, seeded q/k/v biases, the k bias the largest, a prompt of QWEN2_CHECK_PROMPT): gates
# set from its own readings (NVIDIA H100 80GB HBM3, 700 W; layer / logits), each near the geometric mean
# of the larger of the sound and float64 readings and the smallest fault's.  Qwen2-7B fp8: sound
# 9.93e-3 / 3.78e-2, the plain path with float64 attention 1.80e-2 / 3.74e-2; K4's p against the
# sub-tile maximum 3.41e-2 / 5.95e-2, the k bias dropped 6.15e-1 / 4.33e-1.  int8: sound 2.39e-3 /
# 3.63e-2, float64 1.48e-2 / 3.65e-2; K5's p against its tile's own maximum 3.90e-2 / 6.11e-2, the
# padded-stride read 7.84e-1 / 5.92e-1, the k bias dropped 6.15e-1 / 4.32e-1.  int8 d-major all-int8:
# sound 2.39e-3 / 3.63e-2, float64 (K6; K7 as it is) 3.50e-3 / 3.65e-2; K7's p codes rounded down
# 1.00e-1 / 1.05e-1, the padded-stride read 7.89e-1 / 5.97e-1.  Qwen2-0.5B (the eager route on both
# paths): sound 6.95e-7 / 0, the eager route in float64 5.27e-2 / 5.46e-2, the k bias dropped 5.72e-1 /
# 4.28e-1; its layer gate stays the int8 cache's, 14 % above that floor, its logits gate 1.5x above
# it (no rounding-sized fault of its kernels is planted here: B7's, K1's and the norm's are phase 2's
# and phase 7's).
GATES.update({"Qwen2-7B fp8 cache": {"layer": 2.5e-2, "lm_head": 2e-2, "logits": 4.7e-2, "tie_gap": 0.1},
              "Qwen2-7B int8 cache": {"layer": 2.4e-2, "lm_head": 2e-2, "logits": 4.7e-2, "tie_gap": 0.3},
              "Qwen2-7B int8 d-major int8dot": {"layer": 1.9e-2, "lm_head": 2e-2, "logits": 6.2e-2, "tie_gap": 0.3},
              "Qwen2-0.5B int8 cache": {"layer": 6e-2, "lm_head": 2e-2, "logits": 8e-2, "tie_gap": 0.3}})


def gate_failures(r: dict, gates: dict) -> list:
    out = [] if r["finite"] else ["non-finite logits"]
    out += [f"{key} rel {r[key]:.3e} > {gates[key]:g}" for key in ("layer", "lm_head", "logits")
            if not r[key] <= gates[key]]
    if r["decisive_flips"]:
        out.append(f"{r['decisive_flips']} tokens differ at decisive steps")
    if r.get("route_mismatch"):
        out.append(f"{r['route_mismatch']} routing decisions differ on the same router logits")
    if r.get("max_flipped_route_gap", 0.0) > gates.get("route_tie_gap", float("inf")):
        out.append(f"an expert choice flipped at a probability gap of {r['max_flipped_route_gap']:.3e} "
                   f"> {gates['route_tie_gap']:g}")
    if r["generate_mismatch"] and not out:
        out.append(f"generate() picked {r['generate_mismatch']} other tokens")
    return out


def apply_gates(all_readings: dict, gates_of: dict, card) -> None:
    """Fail unless every sound reading passes its gates, the plain path with
    its other rounding does too, and every planted fault fails one."""
    for cache, readings in all_readings.items():
        sound, gates = readings["sound"], gates_of[cache]
        bad = gate_failures(sound, gates)
        if bad:
            raise AssertionError(f"model check, {cache}: {'; '.join(bad)}")
        for key, gate in (("layer", "layer"), ("logits", "logits"), ("max_flipped_route_gap", "route_tie_gap")):
            if gate in gates and not sound[f"floor_{key}"] <= gates[gate]:  # another rounding of correct code passes too
                raise AssertionError(f"model check, {cache}: the plain path with its other rounding fails "
                                     f"the {gate} gate ({sound[f'floor_{key}']:.3e} > {gates[gate]:g})")
        for fault in readings:
            if fault == "sound":
                continue
            caught = gate_failures(readings[fault], gates)
            if not caught:
                raise AssertionError(f"model check, {cache}: planted fault '{fault}' passes every gate")
            log(f"model check, {cache}: planted fault '{fault}' caught: {'; '.join(caught)}")
    log(f"model check passed: gates {json.dumps({c: gates_of[c] for c in all_readings})} [{card}]")


def model_check(dev, card, caches=("float8_e4m3", "int8", "int8 d-major int8dot", "float4_e2m1 d-major")) -> dict:
    """Kernel path vs plain path on the same card, 2 layers at 8B width, b=2,
    16 greedy tokens, with the fp8 cache (K4 throughout), the int8 cache (K4
    at prefill, K5 at every decode step), the int8 d-major cache with the
    all-int8 flag (K6 at prefill, K7 at every decode step) and the fp4
    d-major cache (K6 throughout, after a prompt of 320 tokens); then again
    with each planted fault, which must fail a gate.  Every reading is
    printed before any gate is applied."""
    from torchmx_tpu_torch.models.llama import LlamaConfig
    from torchmx_tpu_torch.quant_api import build_quantized_llama

    qa, qm, _ = quant_configs()
    cfg = LlamaConfig(**{**LLAMA3_8B, "num_hidden_layers": 2})
    model = build_quantized_llama(cfg, qa, qm, dev, torch.Generator(dev).manual_seed(1))
    all_readings = {}
    faults_of = {"float8_e4m3": PLANTED_FAULTS, "int8": PLANTED_FAULTS_INT8,
                 "int8 d-major int8dot": PLANTED_FAULTS_DMAJOR, "float4_e2m1 d-major": PLANTED_FAULTS_FP4_DMAJOR}
    for cache in caches:
        prompt = torch.randint(0, cfg.vocab_size, (2, CHECK_PROMPT.get(cache, 64)),
                               generator=torch.Generator(dev).manual_seed(2), device=dev)
        elem, layout, int8dot = CACHES[cache]
        kv, tie_gap = quant_configs(elem)[2], GATES[cache]["tie_gap"]
        with kv_env(layout, int8dot):
            readings = {"sound": model_readings(model, prompt, 16, kv, True, tie_gap)}
            for fault in faults_of[cache]:
                with planted_fault(fault):
                    readings[fault] = model_readings(model, prompt, 16, kv, False, tie_gap)
        for name, r in readings.items():
            log(f"model check {cache} cache [{name}]: 2 layers at 8B width, b=2, 16 greedy tokens: "
                f"{json.dumps(r)} [{card}]")
        all_readings[f"{cache} cache"] = readings
    del model
    apply_gates(all_readings, {f"{c} cache": GATES[c] for c in caches}, card)
    return all_readings


def model_check_formats(dev, card) -> dict:
    """The same check for this slice's weight formats, each on its own
    2-layer model at 8B width from the same seed: W8A8 over the int8 seq
    cache (B9 at decode and at prefill's o/down, B6 at prefill's q/k/v and
    gate/up, K5 at decode), MXFP6 e3m2 weights with fp8 activations over the
    fp8 cache (B8 throughout), MXFP8 weights over the fp8 cache (K3-fp8
    throughout) and MXFP8 weights under ``TORCHMX_FP8_DOT=1`` (B9-fp8 at
    decode and prefill's o/down, B6 at prefill's q/k/v and gate/up); the
    planted faults of PLANTED_FAULTS_FORMATS must each fail a gate."""
    from torchmx_tpu_torch.models.llama import LlamaConfig
    from torchmx_tpu_torch.quant_api import build_quantized_llama

    cfg = LlamaConfig(**{**LLAMA3_8B, "num_hidden_layers": 2})
    prompt = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator(dev).manual_seed(2), device=dev)
    all_readings = {}
    for name, faults in PLANTED_FAULTS_FORMATS.items():
        weights, acts, cache, knobs = FORMATS[name]
        qa, qm, kv = quant_configs(cache, weights, acts)
        with env_knobs(**knobs):
            model = build_quantized_llama(cfg, qa, qm, dev, torch.Generator(dev).manual_seed(1))
            readings = {"sound": model_readings(model, prompt, 16, kv, True, GATES[name]["tie_gap"])}
            for fault in faults:
                with planted_fault(fault):
                    readings[fault] = model_readings(model, prompt, 16, kv, False, GATES[name]["tie_gap"])
        del model
        for fault, r in readings.items():
            log(f"model check {name} [{fault}]: 2 layers at 8B width, b=2, 16 greedy tokens: "
                f"{json.dumps(r)} [{card}]")
        all_readings[name] = readings
    apply_gates(all_readings, GATES, card)
    return all_readings


def build_model(dev, card, layers: int, seed: int = 0, weights="float4_e2m1", acts="float8_e4m3"):
    """Llama-3-8B at full width, ``layers`` deep: seeded random bf16 weights
    made on the card and quantized (fp4 weights and fp8 activations unless
    told otherwise, in the layout the knobs in force choose) layer by layer."""
    from torchmx_tpu_torch.models.llama import LlamaConfig
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.quant_api import build_quantized_llama

    qa, qm, _ = quant_configs(weights=weights, acts=acts)
    cfg = LlamaConfig(**{**LLAMA3_8B, "num_hidden_layers": layers})
    cuda_lib.reset_launch_counts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_quantized_llama(cfg, qa, qm, dev, torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    layouts = sorted({(m.weight.elem_dtype.name, m.weight.fp4_pack) for m in model.modules() if hasattr(m, "qconfig")
                      and hasattr(m, "weight")})
    log(f"model: built and quantized Llama-3-8B ({layers} layers), {weights} weights / {acts} activations "
        f"(layouts {layouts}), in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card [{card}]")
    log(f"model: launches while building (weight quantization, not a main path): "
        f"{json.dumps(dict(cuda_lib.LAUNCHES))}")
    return model


def halves_launches_per_step(layers: int, kernel: str = "mx_matmul_fp4_halves") -> dict:
    """K3's, K2's and K1's launches in one decode step of a Llama with fp4
    (or fp8) halves weights: K3 at each layer's 7 linears and lm_head; K2
    once each for o_proj and down_proj, and once for lm_head (the wrappers
    take K2 first; q/k/v and gate/up share theirs, which the RMSNorm kernel
    before them applies in its own launch); K1 once a layer, K and V written
    into the cache in one launch."""
    return {kernel: 7 * layers + 1, "mx_fake_quantize": 2 * layers + 1, "mx_quantize": layers}


def w8a8_k1_per_step(layers: int) -> int:
    """K1's launches in a decode step where B9 takes every linear: one for
    q/k/v, one for gate/up, one each for o_proj and down_proj (dot order),
    one for the cache write, a layer; one for lm_head."""
    return 5 * layers + 1


def mixtral_launches_per_step(layers: int) -> dict:
    """Mixtral's decode step: K3 at q/k/v/o and lm_head, B12 at w1, w3 and
    w2, K2 once for o_proj, on x_sorted and on the SwiGLU output, and once
    for lm_head (q/k/v's in the input norm's launch; the post-attention norm
    also feeds the router, so it stays apart); the router kernel and K1 (the
    cache write) once a layer."""
    return dict(mx_matmul_fp4_halves=4 * layers + 1, mx_grouped_matmul=3 * layers,
                mx_fake_quantize=3 * layers + 1, mx_router_logits=layers, mx_quantize=layers)


def run_slice(model, dev, card, cache="float8_e4m3", batches=(1, 32), weights="fp4", want=None):
    """The ``generate`` path over ``cache`` (a key of CACHES; call it inside
    the cache's ``kv_env``) at the given batch sizes; ``weights`` names the
    model's weight format in the log.  With ``want`` ({kernel: launches}),
    every decode step must launch those kernels that often."""
    from torchmx_tpu_torch.models.generate import generate
    from torchmx_tpu_torch.ops import cuda_lib

    kv = quant_configs(CACHES[cache][0])[2]
    cfg = model.config
    if type(cfg).__name__ == "LlamaConfig" and cfg.num_hidden_layers != LLAMA3_8B["num_hidden_layers"]:
        log(f"slice: depth cut to {cfg.num_hidden_layers} of 32 layers")
    # The counts at the start of every forward of the timed run: the first
    # is the prefill, the rest are decode steps.
    at_forward = []
    hook = model.register_forward_pre_hook(
        lambda *_: at_forward.append(collections.Counter(cuda_lib.LAUNCHES)))
    results, launches = {}, collections.Counter()
    for b in batches:
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
        step = results[b]["launches_per_decode_step"]
        if want is not None and {k: step.get(k) for k in want} != want:
            raise AssertionError(f"slice b={b}, {weights} weights: a decode step launched {step}, expected {want}")
        log(f"slice, {weights} weights, {cache} cache: b={b} prompt 64 + 128 new tokens in {dt:.3f} s = {tps:.1f} tok/s, "
            f"peak {peak:.2f} GiB; launches {json.dumps(results[b]['launches'])}, of which prefill "
            f"{json.dumps(results[b]['launches_prefill'])}, per decode step "
            f"{json.dumps(results[b]['launches_per_decode_step'])} [{card}]")
    hook.remove()
    for b in batches:
        results[b].update(latency_and_device_time(model, cfg, kv, dev, b, results[b]["seconds"]))
        log(f"slice breakdown, {weights} weights, {cache} cache, b={b}: {json.dumps(results[b])} [{card}]")
    return dict(launches), results


KERNEL_OF_DEVICE_NAME = (  # substring of the CUDA function name -> kernel
    ("mla_int8dot_kernel", "mx_mla_attention_int8dot"),
    ("mla_kernel", "mx_mla_attention"),
    ("matmul_fp4_pair_kernel", "mx_matmul_fp4_pair"),
    ("reduce_splits_fp4p_kernel", "split-K reduce of B7"),
    ("grouped_reduce_kernel", "split-K reduce of B12"),
    ("router_kernel", "mx_router_logits"),
    ("grouped_wgmma_kernel", "mx_grouped_matmul"),
    ("wgmma_fp8dot_kernel", "mx_matmul_fp8dot"),
    ("wgmma_int8dot_kernel", "mx_matmul_int8dot"),
    ("reduce_splits_b9", "split-K reduce of B9"),
    ("quantize_dot_kernel", "mx_quantize"),
    ("matmul_1byte_kernel", "mx_matmul_1byte"),
    ("reduce_splits_1byte_kernel", "split-K reduce of B6"),
    ("matmul_fp6q_kernel", "mx_matmul_fp6q"),
    ("reduce_splits_fp6q_kernel", "split-K reduce of B8"),
    ("matmul_fp8_halves_kernel", "mx_matmul_fp8_halves"),
    ("reduce_splits_fp8h_kernel", "split-K reduce of K3-fp8"),
    ("rmsnorm_kernel", "mx_rmsnorm"),
    ("chunkdot_kernel", "mx_cached_attention_chunkdot"),
    ("int8dot_kernel", "mx_cached_attention_int8dot"),
    ("dmajor_tile_attention_kernel", "mx_cached_attention_dmajor"),  # the cluster kernel's two layouts
    ("seq_tile_attention_kernel", "mx_cached_attention"),
    ("matmul_fp4_halves_kernel", "mx_matmul_fp4_halves"),
    ("reduce_splits_kernel", "mx_matmul_fp4_halves"),
    ("quantize_rows_kernel", "mx_quantize_rows"),
    ("cache_write_kernel", "mx_quantize"),
    ("fake_quantize_planes_kernel", "K2 planes of B7"),
    ("fake_quantize_kernel", "mx_fake_quantize"),
    ("quantize_kernel", "mx_quantize"),
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


# -- phase 5: the engine -----------------------------------------------------------

ENGINE_BATCH, ENGINE_LEN, ENGINE_CHUNK, PREFIX_LEN = 32, 1024, 128, 128
PLAIN_LAYERS = 4  # depth of the model the engine's plain-path comparison runs at


def make_requests(vocab: int, seed: int, n: int = 48):
    """(the shared prefix, n requests): prompt lengths drawn from 32-512, 64-128
    new tokens each; every fourth request's prompt extends the 128-token
    prefix (by at least 32 tokens)."""
    import random

    rnd = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)

    def toks(k):
        return torch.randint(0, vocab, (k,), generator=gen).tolist()

    prefix = toks(PREFIX_LEN)
    requests = []
    for i in range(n):
        length, n_new = rnd.randint(32, 512), rnd.randint(64, 128)
        if i % 4 == 1:
            length = max(length, PREFIX_LEN + 32)
            prompt = prefix + toks(length - PREFIX_LEN)
        else:
            prompt = toks(length)
        requests.append(dict(id=i, prompt=prompt, n_new=n_new, prefixed=i % 4 == 1))
    return prefix, requests


def drive(eng, requests, follow=None) -> dict:
    """Serve ``requests`` in order, admitting one whenever a slot is free and
    releasing a request once it has its ``n_new`` tokens.  Returns, per
    request id, its tokens, their log-probabilities, why it ended (None: it
    got its tokens) and admission times; and per ``step()`` its duration, the
    time of its return, the launches it made and whether it advanced an
    admission chunk.

    With ``follow`` (request id -> tokens of an earlier run) the engine is
    teacher-forced: it goes on from the earlier run's token wherever it would
    pick one, and what it would have picked itself is returned under
    ``own_picks`` as (request id, token index, own token, top-2 logit gap)."""
    from torchmx_tpu_torch.ops import cuda_lib

    res = {r["id"]: dict(tokens=[], reason=None, n_prompt=len(r["prompt"])) for r in requests}
    queue, slot_req, steps, own_picks = list(requests), {}, [], []
    admitting_req = [None]  # the request whose first token the next one-row pick chooses

    def following_pick(logits):
        top2 = logits.float().topk(2, dim=-1)
        own, gap = top2.indices[:, 0], top2.values[:, 0] - top2.values[:, 1]
        if logits.shape[0] == 1:
            targets = [(0, admitting_req[0]["id"], 0)]
        else:  # a decode step picks the token after each decoding slot's pending one
            targets = [(slot, r["id"], len(res[r["id"]]["tokens"]) + 1)
                       for slot, r in slot_req.items() if slot not in eng._pending]
        own_picks.append((targets, own, gap))
        forced = [(row, follow[rid][idx]) for row, rid, idx in targets if idx < len(follow[rid])]
        tok = own.clone()
        if forced:
            rows, vals = zip(*forced)
            tok[torch.tensor(rows, device=tok.device)] = torch.tensor(vals, device=tok.device)
        return tok, None

    if follow is not None:
        eng._pick = following_pick
    t_start = time.perf_counter()

    def finish(slot, reason):
        r = slot_req.pop(slot)
        res[r["id"]]["reason"] = reason
        res[r["id"]]["logprobs"] = list(eng.logprobs.get(slot, []))

    while queue or slot_req:
        while queue and eng.free_slots():
            r = admitting_req[0] = queue.pop(0)
            t0 = time.perf_counter()
            slot = eng.add(r["prompt"])
            res[r["id"]].update(add_ms=(time.perf_counter() - t0) * 1e3, t_add=t0)
            slot_req[slot] = r
            if not eng.is_active(slot):  # its first continuation was EOS
                finish(slot, eng.finished_reason[slot])
        chunk_slot = next(iter(eng._pending), None)
        admitting_req[0] = slot_req.get(chunk_slot)
        before = collections.Counter(cuda_lib.LAUNCHES)
        t0 = time.perf_counter()
        out = eng.step()
        t1 = time.perf_counter()
        steps.append(dict(ms=(t1 - t0) * 1e3, t=t1, rows=len(out), chunk=chunk_slot is not None,
                          launches=dict(collections.Counter(cuda_lib.LAUNCHES) - before)))
        for slot, tok in out.items():
            rec = res[slot_req[slot]["id"]]
            rec.setdefault("first_token_ms", (t1 - rec["t_add"]) * 1e3)
            rec["tokens"].append(int(tok))
        for slot in list(slot_req):
            if not eng.is_active(slot):
                finish(slot, eng.finished_reason[slot])
            elif len(res[slot_req[slot]["id"]]["tokens"]) >= slot_req[slot]["n_new"]:
                finish(slot, None)
                eng.release(slot)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    flat = [(rid, idx, int(own[row]), float(gap[row]))
            for targets, own, gap in ((t, o.cpu(), g.cpu()) for t, o, g in own_picks) for row, rid, idx in targets]
    return dict(requests=res, steps=steps, seconds=seconds, own_picks=flat,
                tokens=sum(len(r["tokens"]) for r in res.values()))


def expected_stream(free_tokens, n_new, eos, stops):
    """What the engine must emit, and why it ends, for a request whose
    unconstrained greedy stream is ``free_tokens`` (at least n_new + 1 of
    them): the EOS token is never emitted and ends the request at the step
    before it; a stop sequence ends it once emitted."""
    if free_tokens[0] == eos:
        return [], "eos"
    out = []
    for k in range(n_new):
        out.append(free_tokens[k])
        if free_tokens[k + 1] == eos:
            return out, "eos"
        if any(tuple(out[-len(s):]) == s for s in stops):
            return out, "stop"
    return out, None


def first_novel(tokens, lo, hi, width=1):
    """The first index in [lo, hi) whose ``width`` tokens occur nowhere
    earlier in the stream."""
    for i in range(lo, hi):
        if tuple(tokens[i:i + width]) not in [tuple(tokens[j:j + width]) for j in range(i)]:
            return i
    raise AssertionError(f"the greedy stream repeats itself too much to place an end in [{lo}, {hi})")


def same_stream(a: dict, b: dict, what: str) -> None:
    """Tokens and log-probabilities equal bit for bit, and the same ending."""
    if a["tokens"] != b["tokens"] or a["logprobs"] != b["logprobs"] or a["reason"] != b["reason"]:
        k = next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y), None)
        raise AssertionError(f"engine: {what}: streams differ (first token mismatch at {k}; lengths "
                             f"{len(a['tokens'])} / {len(b['tokens'])}; endings {a['reason']} / {b['reason']})")


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def engine_profile(model, kv, requests, prefix, step_ms: float) -> dict:
    """Device time per ``step()`` by kernel from a torch.profiler window of 8
    steady steps with every slot decoding, and the device's idle share of a
    full-batch step of the unprofiled stream (``step_ms``; the profiler slows
    the host, so the window's own step time is reported but not used)."""
    from torchmx_tpu_torch.models.serve import DecodeEngine

    eng = DecodeEngine(model, ENGINE_BATCH, ENGINE_LEN, kv_cache_config=kv)
    eng.cache_prefix(prefix)
    for r in requests[:ENGINE_BATCH]:
        eng.add(r["prompt"])
    for _ in range(4):
        eng.step()
    steps = 8
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev_ms = device_time_by_kernel(prof)
    out = dict(profiled_step_ms=wall_ms)
    if dev_ms["busy"] > 0:
        out["device_ms_per_step"] = {k: v / steps for k, v in dev_ms.items()}
        out["device_idle_share"] = 1.0 - out["device_ms_per_step"]["busy"] / step_ms
    else:
        out["device_ms_per_step"] = "not measured (the profiler recorded no device events)"
    return out


def compare_with_plain_path(dev, card, family: str = "llama") -> dict:
    """The engine on the kernel path against the same engine under
    ``plain_path()``, on a model of PLAIN_LAYERS layers at full width (the
    plain path at 32 layers takes over a second per step): a mini stream runs
    on the kernel path, then again on the plain path, teacher-forced on the
    kernel path's tokens so that both see the same state at every step (a
    random model's logits are flat, and free-running streams part ways at
    the first near tie).  Wherever the plain path's top-2 gap exceeds the
    int8 tie gap, its own pick must be the kernel path's token.  With
    ``mixtral``, a 2-layer Mixtral-8x7B-width model, and the plain run
    replays the kernel run's expert choices (``RouteTape``): its own choices,
    from hidden states that differ by the kernels' rounding through both
    layers and the cache, are reported; on the same logits they must be the
    kernel run's.  (The model check holds the choices from identical layer
    inputs to a near-tie gate.)  ``family`` "deepseek": a 4-layer
    Moonlight-16B-A3B-width model (layer 0 dense, 1-3 MoE) over the int8 seq
    latent cache, its routing replayed the same way (``NoauxRouteTape``)."""
    from torchmx_tpu_torch.models.serve import DecodeEngine
    from torchmx_tpu_torch.ops.backend import plain_path

    mixtral = family != "llama"
    layers = 2 if family == "mixtral" else PLAIN_LAYERS
    if family == "mixtral":
        model = build_mixtral(dev, card, layers, seed=5)
    elif family == "deepseek":
        model = build_moonlight(dev, card, layers, seed=5)
    else:
        model = build_model(dev, card, layers, seed=5)
    tape = {"mixtral": RouteTape, "deepseek": NoauxRouteTape}.get(family, contextlib.nullcontext)()
    kv = quant_configs("int8")[2]
    prefix, requests = make_requests(model.config.vocab_size, seed=11, n=8)
    for r in requests:
        r["n_new"] = 24

    def run(follow=None):
        eng = DecodeEngine(model, ENGINE_BATCH, ENGINE_LEN, kv_cache_config=kv, prefill_chunk=ENGINE_CHUNK)
        eng.cache_prefix(prefix)
        return drive(eng, requests, follow)

    with tape:
        if mixtral:
            tape.mode = "record"
        got = run()
        tokens = {rid: rec["tokens"] for rid, rec in got["requests"].items()}
        if mixtral:
            tape.mode, tape.cursor = "replay", 0
        with plain_path():
            ref = run(follow=tokens)
    tie_gap = GATES["int8"]["tie_gap"]
    decisive = near_ties = 0
    other, worst = [], 0.0  # picks where the plain path would have gone another way
    for rid, idx, own, gap in ref["own_picks"]:
        if idx >= len(tokens[rid]):
            continue
        decisive += gap > tie_gap
        near_ties += gap <= tie_gap
        if own != tokens[rid][idx]:
            other.append((rid, idx, round(gap, 4)))
            worst = max(worst, gap)
    out = dict(model={"mixtral": "Mixtral-8x7B", "deepseek": "Moonlight-16B-A3B"}.get(family, "Llama-3-8B"),
               layers=layers, requests=len(requests),
               steps_compared=decisive + near_ties, decisive_steps=decisive, near_ties=near_ties,
               other_picks=len(other), largest_gap_of_another_pick=worst, tie_gap=tie_gap,
               kernel_seconds=got["seconds"], plain_seconds=ref["seconds"])
    if mixtral:
        st = tape.stats["kernel"]
        out.update(route_mismatch=st["mismatch"], own_route_flips=st["flips"], routed_rows=st["rows"],
                   max_flipped_route_gap=st["max_flip_gap"])
    log(f"engine vs plain path at {layers} layers (full width, chunked admission, prefix, teacher-forced): "
        f"{json.dumps(out)} [{card}]")
    if mixtral and out["route_mismatch"]:
        raise AssertionError("engine vs plain path: the routing differs on the same router logits")
    if worst > tie_gap:
        raise AssertionError(f"engine vs plain path: the plain path picks another token at decisive steps: "
                             f"{[o for o in other if o[2] > tie_gap]}")
    if decisive < 30:
        raise AssertionError(f"engine vs plain path: only {decisive} decisive steps were compared")
    return out


def run_engine(model, dev, card, cache="int8", weights="fp4") -> dict:
    """The serving path: ``DecodeEngine`` over an int8 MX KV cache (``cache``
    is a key of CACHES; call it inside the cache's ``kv_env``), 32 slots of
    1024 positions, a seeded stream of 48 requests.  Checks that a request's
    stream (tokens and log-probabilities, bit for bit) is the same alone and
    in company, admitted whole, in chunks or over the cached prefix; that
    EOS, a stop sequence and a full cache each end a request with the right
    reason; and that every decode step launched K3, K2, K1 and its decode
    attention kernel (K5 in the seq layout; K7, which quantizes q in its
    prologue, in the d-major layout with the all-int8 flag) as often as the
    model's depth says, and no other kernel."""
    from torchmx_tpu_torch.models.serve import DecodeEngine
    from torchmx_tpu_torch.ops import cuda_lib

    kv = quant_configs(CACHES[cache][0])[2]
    k7 = CACHES[cache][1:] == ("dmajor", True)
    layers = model.config.num_hidden_layers
    prefix, requests = make_requests(model.config.vocab_size, seed=7)

    def engine(max_len=ENGINE_LEN, chunk=None, with_prefix=True, **kw):
        eng = DecodeEngine(model, ENGINE_BATCH, max_len, kv_cache_config=kv, prefill_chunk=chunk,
                           return_logprobs=True, **kw)
        if with_prefix:
            eng.cache_prefix(prefix)
        return eng

    def alone(r, **kw):
        """The request's unconstrained stream (one token more than it asks
        for), decoding alone: the other 31 slots idle."""
        return drive(engine(**kw), [dict(r, n_new=r["n_new"] + 1)])["requests"][r["id"]]

    # 1. Four requests alone; an EOS token and a stop sequence chosen from
    # their streams so that each ends one of them early.
    checked = [requests[i] for i in (0, 1, 2, 3)]  # 1 extends the prefix
    drive(engine(), [dict(requests[4], n_new=4)])  # warm-up
    free = {r["id"]: alone(r) for r in checked}
    x, y = free[0]["tokens"], free[2]["tokens"]
    eos = x[first_novel(x, 16, 48)]
    j = first_novel(y, 16, 48, width=2)
    stops = [tuple(y[j:j + 2])]
    if eos in y[:j + 3]:
        raise AssertionError("engine: the EOS token ends request 2 before its stop sequence")
    log(f"engine, {cache} cache: EOS token {eos} (request 0 ends before its token {x.index(eos)}), "
        f"stop sequence {stops[0]} (request 2 ends after its token {j + 1})")
    rules = dict(eos_token_id=eos, stop_sequences=stops)

    # 2. The stream of 48, whole admissions over the cached prefix.  Counts
    # are set to 0 just before and read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine(**rules)
    cuda_lib.reset_launch_counts()
    run = drive(eng, requests)
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hits = eng.prefix_hit_tokens
    del eng
    for r in checked:
        want, reason = expected_stream(free[r["id"]]["tokens"], r["n_new"], eos, stops)
        same_stream(dict(tokens=want, logprobs=free[r["id"]]["logprobs"][:len(want)], reason=reason),
                    run["requests"][r["id"]], f"request {r['id']} alone vs among {ENGINE_BATCH}")
    if run["requests"][0]["reason"] != "eos" or run["requests"][2]["reason"] != "stop":
        raise AssertionError("engine: the EOS token and the stop sequence did not end requests 0 and 2")
    if hits != PREFIX_LEN * sum(r["prefixed"] for r in requests):
        raise AssertionError(f"engine: {hits} prompt tokens reused from the prefix cache")
    for rec in run["requests"].values():
        n = len(rec["tokens"])
        if not all(0 <= t < model.config.vocab_size for t in rec["tokens"]) or n != len(rec["logprobs"]):
            raise AssertionError("engine: a stream holds bad tokens")
        if not all(lp == lp and lp <= 0 for lp in rec["logprobs"]):
            raise AssertionError("engine: a stream holds bad log-probabilities")
    linears = 7 * layers + 1
    want = {"mx_rmsnorm": 2 * layers + 1,
            "mx_cached_attention_int8dot" if k7 else "mx_cached_attention_chunkdot": layers}
    if weights == "moonlight":
        want = moonlight_launches_per_step(model.config)
    elif weights == "w8a8":  # B9 takes every linear; K1 quantizes its x (once for q/k/v, once for gate/up)
        want.update(mx_matmul_int8dot=linears, mx_quantize=w8a8_k1_per_step(layers))
    elif weights == "mixtral":
        want.update(mixtral_launches_per_step(layers))
    else:
        want.update(halves_launches_per_step(layers))  # K7 quantizes q itself
    for st in run["steps"]:
        if st["rows"] and st["launches"] != want:
            raise AssertionError(f"engine: a decode step launched {st['launches']}, expected {want}")
    attention = "B13" if weights == "moonlight" else "K7, not K6" if k7 else "K5, not K4"
    log(f"engine, {weights} {cache} cache: every one of {len(run['steps'])} decode steps launched {json.dumps(want)}: "
        f"{attention}, served each of them; the whole stream launched {json.dumps(launches)}")

    # 3. Admitted whole without the prefix cache, and in chunks among others.
    same_stream(free[1], alone(requests[1], with_prefix=False), "request 1 over the prefix vs whole")
    chunked = drive(engine(chunk=ENGINE_CHUNK, **rules), requests[:16])
    if not any(st["chunk"] for st in chunked["steps"]):
        raise AssertionError("engine: no admission went through chunks")
    for r in requests[:16]:
        same_stream(run["requests"][r["id"]], chunked["requests"][r["id"]],
                    f"request {r['id']} admitted whole vs in chunks of {ENGINE_CHUNK}")
    log(f"engine, {cache} cache: streams bit-identical (tokens and log-probabilities): requests 0-3 alone vs among "
        f"{ENGINE_BATCH}; request 1 over the cached prefix vs whole; requests 0-15 whole vs in chunks of "
        f"{ENGINE_CHUNK} (prefix reuse rounded to the chunk grid)")

    # 4. A slot run to the end of its cache (256 positions): its last write
    # is clamped; alone and among 8 others.
    _, extra = make_requests(model.config.vocab_size, seed=9, n=9)
    long_r = dict(extra[0], prompt=(extra[0]["prompt"] * 8)[:200], n_new=10**6)
    others = [dict(r, prompt=r["prompt"][:48], n_new=40) for r in extra[1:]]
    a = drive(engine(max_len=256, with_prefix=False), [long_r])["requests"][long_r["id"]]
    b = drive(engine(max_len=256, with_prefix=False), [long_r] + others)["requests"][long_r["id"]]
    same_stream(a, b, "the request run to cache_full, alone vs among 8")
    if a["reason"] != "cache_full" or len(a["tokens"]) != 256 - 200 + 1:
        raise AssertionError(f"engine: cache_full after {len(a['tokens'])} tokens, reason {a['reason']}")
    reasons = collections.Counter(str(r["reason"]) for r in run["requests"].values())
    reasons["cache_full"] += 1
    log(f"engine, {cache} cache: endings over the stream of {len(requests)} (None = got its tokens) plus the drained slot: "
        f"{json.dumps(dict(reasons))}")

    # 5. Numbers.
    gaps = [b_["t"] - a_["t"] for a_, b_ in zip(run["steps"], run["steps"][1:])]
    full = [st["ms"] for st in run["steps"] if st["rows"] == ENGINE_BATCH]
    admissions = sorted((r["n_prompt"], round(r["add_ms"], 1)) for r in run["requests"].values())
    out = dict(cache=cache, weights=weights, requests=len(requests), tokens=run["tokens"], seconds=run["seconds"],
               tokens_per_s=run["tokens"] / run["seconds"], steps=len(run["steps"]),
               step_gap_ms_median=statistics.median(gaps) * 1e3, step_gap_ms_p90=percentile(gaps, 0.9) * 1e3,
               full_batch_step_ms_median=statistics.median(full) if full else None,
               full_batch_steps=len(full), admission_ms_by_prompt_length=admissions,
               chunked_first_token_ms=sorted((r["n_prompt"], round(r["first_token_ms"], 1))
                                             for r in chunked["requests"].values() if "first_token_ms" in r),
               chunked_step_ms_median=statistics.median(st["ms"] for st in chunked["steps"] if st["chunk"]),
               peak_gib=peak, prefix_hit_tokens=hits, launches=launches, launches_per_decode_step=want,
               endings=dict(reasons), layers=layers)
    if not full:
        raise AssertionError("engine: the stream never had every slot decoding")
    out.update(engine_profile(model, kv, requests, prefix, out["full_batch_step_ms_median"]))
    log(f"engine, {cache} cache: {json.dumps(out)} [{card}]")
    return out


def run_formats(dev, card, layers: int):
    """This slice's main paths at Llama-3-8B width, each model built, driven
    with the counts set to 0 just before and read just after, and dropped:
    the W8A8 engine over the int8 seq cache, then ``generate`` at b=32 over
    the fp8 cache with MXFP6 e3m2, MXFP8 (halves) and MXFP8 under
    ``TORCHMX_FP8_DOT=1`` (flat) weights.  Returns (launches by path,
    launches per decode step by path, results)."""
    paths, per_step, results = {}, {}, {}
    weights, acts, _, _ = FORMATS["W8A8 int8 cache"]
    model = build_model(dev, card, layers, weights=weights, acts=acts)
    results["engine_w8a8"] = run_engine(model, dev, card, "int8", weights="w8a8")
    paths["engine_w8a8"] = results["engine_w8a8"]["launches"]
    per_step["engine_w8a8"] = results["engine_w8a8"]["launches_per_decode_step"]
    del model
    for path, name in (("generate_fp6", "MXFP6 e3m2 fp8 cache"), ("generate_fp8", "MXFP8 fp8 cache"),
                       ("generate_fp8dot", "MXFP8 FP8_DOT fp8 cache")):
        weights, acts, cache, knobs = FORMATS[name]
        with env_knobs(**knobs):
            model = build_model(dev, card, layers, weights=weights, acts=acts)
            want = {"generate_fp8": halves_launches_per_step(layers, "mx_matmul_fp8_halves"),
                    "generate_fp8dot": {"mx_matmul_fp8dot": 7 * layers + 1, "mx_quantize": w8a8_k1_per_step(layers)},
                    "generate_fp6": {"mx_matmul_fp6q": 7 * layers + 1, "mx_fake_quantize": 2 * layers + 1,
                                     "mx_quantize": layers}}[path]
            paths[path], res = run_slice(model, dev, card, cache, batches=(32,), weights=name, want=want)
        del model
        results[path] = res[32]
        per_step[f"{path}_b32"] = res[32]["launches_per_decode_step"]
    # Each decode step of P6 launched B8 at each of a layer's 7 linears and at
    # lm_head, K2 for o_proj, down_proj and lm_head (q/k/v's and gate/up's in
    # their norms' launches), K1 once a layer; of PD, B9-fp8 at every linear
    # and K1 five times a layer and once for lm_head (run_slice checked both).
    return paths, per_step, results


# -- this slice: Mixtral-8x7B and B12 ------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1 config.json: the model of phases 3b and 8.
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, head_dim=128, rope_theta=1e6,
                    rms_norm_eps=1e-5, max_position_embeddings=32768, sliding_window=None,
                    num_local_experts=8, num_experts_per_tok=2)
GROUPED_TM = 128  # the grouped block's row tile (grouped_tm)
# B12's linears on the main paths, (E, top-k, K, N): Mixtral-8x7B's w1/w3 and
# w2, Moonlight-16B-A3B's routed w1/w3 and w2 (moe_intermediate_size 1408).
B12_SHAPES = {"w1/w3": (8, 2, 4096, 14336), "w2": (8, 2, 14336, 4096),
              "Moonlight w1/w3": (64, 6, 2048, 1408), "Moonlight w2": (64, 6, 1408, 2048)}
# Token counts B12 sees on the main path: decode at b=1 and b=32, an engine
# admission, prefill of b=32 x 64.
B12_MAIN_T = (1, 32, 512, 2048)
# The design target against torch._grouped_mm (decode b=32: no slower; prefill
# T=2048: at most 2.5x), read on the int8 rows of both models.
B12_TARGET = {32: 1.0, 2048: 2.5}


def _routing(dev, gen, T, routed2, E=8, k=2):
    """(T, k) int32 experts: every token on experts 0 .. k-1 (routed-2 at
    k = 2), or k distinct random experts per token (spread)."""
    if routed2:
        return torch.arange(k, dtype=torch.int32, device=dev).expand(T, k).contiguous()
    return torch.rand(T, E, generator=gen, device=dev).argsort(dim=1)[:, :k].to(torch.int32)


def _stacked_codes(w, elem):
    """Stacked (E, K, N) codes and (E, K/32, N) scales of ``elem`` itself
    (``quantize_stacked`` re-codes e2m3 as int8)."""
    from torchmx_tpu_torch.mx_array import MXTensor, quantize_stacked

    if elem != "float6_e2m3":
        return quantize_stacked(w, elem)
    ts = [MXTensor.to_mx(w[e].t().contiguous(), elem) for e in range(w.shape[0])]
    return (torch.stack([t.data.t() for t in ts]).contiguous(),
            torch.stack([t.scale_e8m0.t() for t in ts]).contiguous())


def _b12_bound(T, K, N, live_experts, elem, k=2):
    """Bytes: the useful rows of x and of the output, the live experts'
    weights (codes and scales); operations: 2 * A * N * K, A = k T."""
    A = k * T
    wb = K * N * (2 if elem is None else 1 + 1 / 32)
    return bound(A * K * 2 + live_experts * wb + A * N * 2, 2 * A * N * K)


def _grouped_library(xs, w_bf16, te, tr, tm):
    """(the one PyTorch call computing B12's function on the live rows, its
    name): ``torch._grouped_mm`` over the bf16-dequantized experts where this
    PyTorch has it, else the per-expert ``torch.matmul``s on each expert's
    live rows, in one function."""
    E = w_bf16.shape[0]
    tiles = tr.cpu() > 0
    per_e = torch.bincount(te.cpu()[tiles].long(), minlength=E) * tm
    total = int(per_e.sum())
    a = xs[:total]
    offs = torch.cumsum(per_e, 0).to(torch.int32).to(xs.device)
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(a, w_bf16, offs=offs, out_dtype=torch.bfloat16)
            return (lambda: torch._grouped_mm(a, w_bf16, offs=offs, out_dtype=torch.bfloat16)), "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as exc:
            log(f"torch._grouped_mm not usable here ({str(exc).splitlines()[0][:120]}): per-expert torch.matmul")
    bounds = [0] + torch.cumsum(per_e, 0).tolist()
    parts = [(a[bounds[e]:bounds[e + 1]], w_bf16[e]) for e in range(E) if bounds[e + 1] > bounds[e]]
    return (lambda: [torch.matmul(x, w) for x, w in parts]), "per-expert torch.matmul"


def check_grouped_kernel(dev, timer, gen):
    """B12 against its plain version (rel <= 1e-2), each expert's rows
    bounded by the token count as the MoE block bounds them: bf16 experts and
    the four code formats at tm 8 and 128 on ``bench.py:338``'s shape (E=8,
    K=4096, N=14336, T=8 tokens, k=2) routed-2 and spread and on Moonlight's
    w1/w3 at decode b=32; then every main-path shape of both models (Mixtral's
    w1/w3 and w2, top-2 of 8; Moonlight's routed w1/w3 and w2, top-6 of 64) at
    every token count it sees, int8 experts (fp4 re-coded) and Mixtral's e3m2.
    Dead and padding rows must be 0 and every live tile of code experts must
    give B6's bytes on the same rows.  Timed (kernel, plain, ``torch._grouped_mm``,
    the bound) at the main path's int8 calls and on the bench shape, whose
    routed-2 / spread ratio is the dead-tile skip; the decode b=32 and
    prefill T=2048 ratios to the library call are read against
    ``B12_TARGET``.  Returns (entry, rows)."""
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops import cuda_moe, moe

    rows, worst = [], 0.0
    for label, (E, k, K, N) in B12_SHAPES.items():
        w = torch.empty((E, K, N), dtype=torch.bfloat16, device=dev)
        for e in range(E):
            w[e] = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        weights = {None: (w, None)}
        weights.update({el: _stacked_codes(w, el) for el in kf.CODE_FORMATS_1BYTE})

        def run(T, routed2, tm, elem, time_it=False, what=""):
            nonlocal worst
            x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
            xs, te, tr, _ = moe.group_tokens(x, _routing(dev, gen, T, routed2, E, k), tm, E)
            wq, sc = weights[elem]
            bounds = moe.row_bounds(T, k, E)
            out = cuda_moe.mx_grouped_matmul(xs, wq, te, tr, tm, sc, elem, **bounds)
            ref = cuda_moe.mx_grouped_matmul_plain(xs, wq, te, tr, tm, sc, elem, **bounds)
            rel = _rel_max(out, ref)
            worst = max(worst, (out.float() - ref.float()).abs().max().item())
            ext = min(T, tm)
            n_live = tr.clamp(max=ext)
            dead = torch.arange(xs.shape[0], device=dev) % tm >= n_live.repeat_interleave(tm)
            live = sorted({e for e, n in zip(te.tolist(), tr.tolist()) if n})
            msg = (f"B12 {label} {what} T={T} tm={tm} {elem or 'bf16'}: R={xs.shape[0]}, {len(live)} live experts, "
                   f"rel err {rel:.3e}")
            if not (rel <= 1e-2 and bool((out[dead] == 0).all())):
                raise AssertionError(msg + ", or a dead or padding row is not 0")
            if elem is not None:
                for t, (e, n) in enumerate(zip(te.tolist(), n_live.tolist())):
                    r = slice(t * tm, t * tm + n)
                    if n and not torch.equal(out[r], kf.mx_matmul_1byte(xs[r].contiguous(), wq[e], sc[e], elem)):
                        raise AssertionError(msg + f": tile {t} is not B6's bytes")
                msg += ", every live tile B6's bytes"
            log(msg)
            if time_it:
                w_bf16 = w if elem is None else torch.stack([kf.dequantize_1byte(wq[e], sc[e], elem) for e in range(E)])
                lib, lib_name = _grouped_library(xs, w_bf16, te, tr, tm)
                t_b, by = _b12_bound(T, K, N, len(live), elem, k)
                plan = cuda_moe.plan_grouped(xs.shape[0], N, K, tm, torch.cuda.get_device_properties(dev)
                                             .multi_processor_count, **bounds)
                row = dict(kernel="mx_grouped_matmul", linear=label, case=what, T=T, k=k, E=E, R=xs.shape[0], tm=tm,
                           K=K, N=N, elem=elem or "bf16", live_experts=len(live), nb=plan.nb, walk=plan.walk,
                           splits=plan.splits,
                           ms=timer(lambda: cuda_moe.mx_grouped_matmul(xs, wq, te, tr, tm, sc, elem, **bounds)),
                           plain_ms=timer(lambda: cuda_moe.mx_grouped_matmul_plain(xs, wq, te, tr, tm, sc, elem,
                                                                                   **bounds), reps=3),
                           library_ms=timer(lib), library=lib_name, bound_ms=t_b, bound_by=by)
                row["x_library"] = row["ms"] / row["library_ms"]
                log("B12 timing", json.dumps(row))
                rows.append(row)
                del w_bf16

        if label == "w1/w3":  # bench.py:338's shape, every format, both row tiles
            for elem in (None,) + kf.CODE_FORMATS_1BYTE:
                for tm in (8, GROUPED_TM):
                    for routed2 in (True, False):
                        run(8, routed2, tm, elem, time_it=tm == GROUPED_TM and elem in (None, "int8"),
                            what="bench routed-2" if routed2 else "bench spread")
        if label == "Moonlight w1/w3":  # every format at Moonlight's decode b=32
            for elem in (None,) + kf.CODE_FORMATS_1BYTE:
                for tm in (8, GROUPED_TM):
                    run(32, False, tm, elem, what="decode b=32, every format")
        for T in B12_MAIN_T:  # the main path's calls: int8 (fp4 re-coded), and Mixtral's e3m2 experts
            run(T, False, GROUPED_TM, "int8", time_it=True, what="main path")
            if E == 8:
                run(T, False, GROUPED_TM, "float6_e3m2", what="main path")
        del weights, w
        torch.cuda.empty_cache()
    for elem in ("bf16", "int8"):
        r2, sp = (next(r for r in rows if r["case"] == c and r["elem"] == elem) for c in ("bench routed-2", "bench spread"))
        log(f"B12 bench shape {elem}: routed-2 {r2['ms']:.4f} ms against spread {sp['ms']:.4f} ms "
            f"(ratio {r2['ms'] / sp['ms']:.3f}; the dead-tile skip)")
    for r in rows:
        if r["case"] == "main path" and r["T"] in B12_TARGET:
            met = "met" if r["x_library"] <= B12_TARGET[r["T"]] else "missed"
            log(f"B12 design target, {r['linear']} T={r['T']}: {r['ms']:.4f} ms against {r['library']} "
                f"{r['library_ms']:.4f} ms = {r['x_library']:.2f}x (target <= {B12_TARGET[r['T']]}x): {met}")
    pick = next(r for r in rows if r["case"] == "main path" and r["T"] == 32 and r["linear"] == "w1/w3")
    return dict(name="mx_grouped_matmul", route="cuda", source="torchmx_tpu_torch/csrc/mx_grouped_matmul.cu",
                replaces="torchmx_tpu/ops/pallas_moe.py:54/:74/:136",
                shape=f"w1 decode b=32: T=32 k=2 R={pick['R']} tm=128 K=4096 N=14336 int8 experts",
                max_abs_err=worst, tolerance="rel <= 1e-2 (max abs over max abs); B6's bytes on code experts",
                library=pick["library"],
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}), rows


ROUTER_T = (1, 32, 2048)  # decode b=1, b=32, prefill b=32 x 64


def check_router_kernel(dev, timer, gen):
    """The router kernel against its plain version (the same fixed summation
    order) bit for bit, at the main path's token counts, timed beside the
    bf16 ``torch.matmul``.  Returns (entry, rows)."""
    from torchmx_tpu_torch.ops import cuda_moe

    E, H, rows, worst, worst_steps = 8, 4096, [], 0.0, 0.0
    w = (torch.randn(E, H, generator=gen, device=dev) * H ** -0.5).to(torch.bfloat16)
    for T in ROUTER_T:
        x = torch.randn(T, H, generator=gen, device=dev).to(torch.bfloat16)
        out, ref = cuda_moe.mx_router_logits(x, w), cuda_moe.mx_router_logits_plain(x, w)
        steps = bf16_steps(out, ref)
        worst, worst_steps = max(worst, max_abs_diff(out, ref)), max(worst_steps, steps)
        log(f"mx_router_logits T={T}: {int((out != ref).sum())} of {out.numel()} logits differ from the plain "
            f"version's, at most {steps:.3g} bf16 steps")
        if steps > 0.0:
            raise AssertionError(f"mx_router_logits T={T}: {steps} bf16 steps from the plain version")
        t_b, by = bound(2 * T * H + 2 * E * H + 2 * T * E, 2 * T * E * H)
        row = dict(T=T, ms=timer(lambda: cuda_moe.mx_router_logits(x, w)),
                   plain_ms=timer(lambda: cuda_moe.mx_router_logits_plain(x, w), reps=5),
                   library_ms=timer(lambda: torch.matmul(x, w.t())), bound_ms=t_b, bound_by=by)
        log("mx_router_logits timing", json.dumps(row))
        rows.append(row)
    pick = rows[1]
    return dict(name="mx_router_logits", route="cuda", source="torchmx_tpu_torch/csrc/mx_router.cu",
                replaces="torchmx_tpu/layers/mx_mixtral_moe.py:249",
                repair="no TPU kernel: the JAX router is a plain jnp matmul; this kernel repairs the port's row "
                       "invariance (cuBLAS sums a row in another order at other row counts)",
                shape="T=32 H=4096 E=8", max_abs_err=worst, bf16_steps=worst_steps, tolerance="bit for bit",
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}), rows


def check_moe_row_invariance(dev) -> dict:
    """B12 and the router at every token count from 1 to 511: each token's
    rows (gathered by ``dest``) and each token's router logits must keep
    their bytes whatever the other tokens are; B12 over int8 experts at
    Mixtral's and Moonlight's w1 and w2 shapes (the wgmma n, the walk and the
    two-pass form change with the count), the router on 4 draws."""
    from torchmx_tpu_torch.models.mixtral import router_logits
    from torchmx_tpu_torch.mx_array import quantize_stacked
    from torchmx_tpu_torch.ops import cuda_moe, moe

    gen = torch.Generator(dev).manual_seed(8765)
    bad = []
    for label, (E, top_k, K, N) in B12_SHAPES.items():
        w = torch.empty((E, K, N), dtype=torch.bfloat16, device=dev)
        for e in range(E):
            w[e] = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        wq, sc = quantize_stacked(w, "int8")
        del w
        x = torch.randn(512, K, generator=gen, device=dev).to(torch.bfloat16)
        top = _routing(dev, gen, 512, False, E, top_k)

        def rows_of(k):  # k tokens, each expert's rows bounded by k: the wgmma n, walk or two passes follow k
            xs, te, tr, dest = moe.group_tokens(x[:k], top[:k], GROUPED_TM, E)
            return cuda_moe.mx_grouped_matmul(xs, wq, te, tr, GROUPED_TM, sc, "int8",
                                              **moe.row_bounds(k, top_k, E))[dest.long()]

        full = rows_of(512)
        bad += [f"B12 {label} tokens={k}" for k in range(1, 512) if not torch.equal(rows_of(k), full[:top_k * k])]
        del wq, sc
    gw = (torch.randn(E, 4096, generator=gen, device=dev) * 4096 ** -0.5).to(torch.bfloat16)
    cublas = collections.Counter()  # the cuBLAS product's counts that differ: what the kernel repairs

    def cublas_logits(t):
        return (t.float() @ gw.float().t()).to(torch.bfloat16)

    for _ in range(4):
        x = torch.randn(512, 4096, generator=gen, device=dev).to(torch.bfloat16)
        full = router_logits(x, gw)
        bad += [f"router tokens={k}" for k in range(1, 512) if not torch.equal(router_logits(x[:k], gw), full[:k])]
        full = cublas_logits(x)
        cublas.update(k for k in range(1, 512) if not torch.equal(cublas_logits(x[:k]), full[:k]))
    if bad:
        raise AssertionError(f"a token's result depends on the number of tokens: {bad[:20]} ({len(bad)} counts)")
    log(f"row invariance: B12 (int8 experts, Mixtral's and Moonlight's w1 and w2 shapes) and the router kernel (4 "
        f"draws) give every token the "
        f"same bytes at every count from 1 to 511; the cuBLAS router differed at {len(cublas)} counts "
        f"(first: {sorted(cublas)[:12]})")
    return dict(counts="1-511", b12_shapes=list(B12_SHAPES), router_draws=4, cublas_router_counts_differing=len(cublas))


class RouteTape:
    """Routing decisions of the plain path, replayed on the kernel path.

    Which experts run is a discontinuous function of the router logits: a
    kernel path that differs from the plain path by a rounding may pick
    another expert where two probabilities nearly tie, and that token's
    output then differs by a whole expert.  So the model check holds the
    kernels under the same decisions and the routing apart: installed as
    ``models.mixtral.route_topk_raw`` (``NoauxRouteTape``: DeepSeek's
    ``models.deepseek.route_noaux_tc``), the tape records the plain path's
    decisions ("record"); on the kernel path ("replay") a token whose own
    experts differ from the plain path's takes the plain path's experts and
    weights, every other token keeps its own.  The kernel path also runs its
    routing function on the plain path's inputs, whose decisions must be the
    same (``route_mismatch``); its own decisions may differ only at near
    ties (``route_flips``, the largest plain-path gap between the k-th and
    (k+1)-th choice among them: probabilities for Mixtral, the biased
    sigmoid scores for DeepSeek)."""

    def __init__(self, module=None, attr="route_topk_raw"):
        if module is None:
            from torchmx_tpu_torch.models import mixtral as module
        self.module, self.attr, self.orig = module, attr, getattr(module, attr)
        self.mode, self.routes, self.cursor = None, [], 0
        self.who = "kernel"  # whose replays are counted: "kernel" or "floor" (the plain path, another rounding)
        self.stats = {w: dict(mismatch=0, flips=0, rows=0, max_flip_gap=0.0) for w in ("kernel", "floor")}
        self.flipped_rows = None

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)

    @staticmethod
    def _sets(idx):
        return idx.sort(dim=-1).values

    @staticmethod
    def _gap(inputs, k):
        """(T,) gap between the k-th and (k+1)-th choice of the inputs."""
        logits = inputs[0]
        p = torch.softmax(logits.float(), dim=-1).sort(dim=-1, descending=True).values
        return p[:, k - 1] - p[:, k]

    def _k(self, inputs):
        return inputs[1]

    def __call__(self, *inputs):
        own = self.orig(*inputs)
        if self.mode == "record":
            self.routes.append((inputs, own))
            return own
        if self.mode != "replay":
            return own
        ref_inputs, ref = self.routes[self.cursor]
        self.cursor += 1
        st = self.stats[self.who]
        same_inputs = self.orig(*ref_inputs)[1]
        st["mismatch"] += int((self._sets(same_inputs) != self._sets(ref[1])).any(dim=-1).sum())
        flipped = (self._sets(own[1]) != self._sets(ref[1])).any(dim=-1)
        gap = self._gap(ref_inputs, self._k(ref_inputs))[flipped]
        st["flips"] += int(flipped.sum())
        st["rows"] += int(flipped.numel())
        if gap.numel():
            st["max_flip_gap"] = max(st["max_flip_gap"], float(gap.max()))
        if self.flipped_rows is not None and self.who == "kernel":
            self.flipped_rows |= flipped.reshape(self.flipped_rows.shape[0], -1).any(dim=1)
        keep = flipped[:, None]  # a token whose experts differ takes the plain path's choice and weights
        return torch.where(keep, ref[0], own[0]), torch.where(keep, ref[1], own[1])


class NoauxRouteTape(RouteTape):
    """The tape over DeepSeek's ``route_noaux_tc(scores, bias, config)``; the
    gap is that of the biased, group-masked choice values."""

    def __init__(self):
        from torchmx_tpu_torch.models import deepseek

        super().__init__(deepseek, "route_noaux_tc")

    @staticmethod
    def _gap(inputs, k):
        from torchmx_tpu_torch.models import deepseek

        v = deepseek.noaux_choice(*inputs).sort(dim=-1, descending=True).values
        return v[:, k - 1] - v[:, k]

    def _k(self, inputs):
        return inputs[2].num_experts_per_tok


MIXTRAL_FAULTS = ("B12 contracts tile t with expert tile_expert[t] + 1 mod E", "B12 scale row of the next K block",
                  "B12 kernel: W's TMA row coordinate takes the expert's K offset one MX block late",
                  "B12 kernel: a live tile's row extent one row short",
                  "router tie-break reversed", "combine_tokens drops the second expert",
                  "an expert choice flipped at a gap above 5e-2")
# The model checks of this slice: name -> (weight format, planted faults).
MIXTRAL_CHECKS = {"Mixtral fp4 grouped int8 cache": ("float4_e2m1", MIXTRAL_FAULTS),
                  "Mixtral e3m2 grouped int8 cache": ("float6_e3m2", ())}


@contextlib.contextmanager
def moe_fault(name):
    """A wrong B12, router or combine, on the kernel path only."""
    from torchmx_tpu_torch.models import mixtral
    from torchmx_tpu_torch.ops import cuda_moe, moe
    from torchmx_tpu_torch.ops.backend import on_cuda

    if name.startswith("B12"):
        mod, attr = cuda_moe, "mx_grouped_matmul"
        orig = cuda_moe.mx_grouped_matmul

        def faulty(x, w, te, tr, tm, w_scale=None, elem_name=None, max_rows=None, max_experts=None):
            fault = 0
            if on_cuda(x):
                if "TMA row" in name:
                    fault = cuda_moe.B12_FAULTS["expert K offset one block late"]
                elif "extent" in name:
                    fault = cuda_moe.B12_FAULTS["extent one row short"]
                elif "expert" in name:
                    te = ((te + 1) % w.shape[0]).to(torch.int32)
                else:
                    w_scale = w_scale.roll(-1, dims=1)
            return orig(x, w, te, tr, tm, w_scale, elem_name, max_rows, max_experts, fault)
    elif name.startswith("router"):
        mod, attr = mixtral, "route_topk_raw"
        orig = mixtral.route_topk_raw

        def faulty(logits, k):
            if not on_cuda(logits):
                return orig(logits, k)
            E = logits.shape[-1]
            vals, idx = orig(logits.flip(-1), k)  # the higher index first among equal values
            return vals, (E - 1 - idx).to(torch.int32)
    elif name.startswith("an expert choice"):
        mod, attr = mixtral, "route_topk_raw"
        orig = mixtral.route_topk_raw

        def faulty(logits, k):
            vals, idx = orig(logits, k)
            if not on_cuda(logits):
                return vals, idx
            # The first token whose k-th and (k+1)-th probabilities lie more
            # than 5e-2 apart takes its (k+1)-th expert in place of its k-th.
            p, order = torch.sort(torch.softmax(logits.float(), dim=-1), dim=-1, descending=True, stable=True)
            wide = torch.nonzero(p[:, k - 1] - p[:, k] > 5e-2)
            if wide.numel():
                t = int(wide[0, 0])
                idx = idx.clone()
                idx[t, k - 1] = order[t, k].to(torch.int32)
            return vals, idx
    else:
        mod, attr = moe, "combine_tokens"
        orig = moe.combine_tokens

        def faulty(y_sorted, dest, top_vals):
            if on_cuda(y_sorted):
                top_vals = top_vals * torch.tensor([1.0] + [0.0] * (top_vals.shape[1] - 1), device=top_vals.device)
            return orig(y_sorted, dest, top_vals)
    setattr(mod, attr, faulty)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def build_mixtral(dev, card, layers: int, seed: int = 0, weights="float4_e2m1", acts="float8_e4m3",
                  grouped: bool = True, tied_router: bool = False):
    """Mixtral-8x7B at full width, ``layers`` deep: seeded random bf16 weights
    made on the card and quantized layer by layer (the grouped block over
    stacked codes unless ``grouped`` is False).  ``tied_router`` makes each
    layer's router rows 0 and 1 equal: the two experts' logits then tie
    exactly on every token (the tie-break's test)."""
    from torchmx_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.quant_api import build_quantized

    qa, qm, _ = quant_configs(weights=weights, acts=acts)
    cfg = MixtralConfig(**{**MIXTRAL_8X7B, "num_hidden_layers": layers})

    def prepare(layer):
        layer.mlp.grouped, layer.mlp.grouped_tm = grouped, GROUPED_TM
        if tied_router:
            layer.mlp.gate.weight[1] = layer.mlp.gate.weight[0]

    cuda_lib.reset_launch_counts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_quantized(MixtralForCausalLM, cfg, qa, qm, dev, torch.Generator(dev).manual_seed(seed), prepare)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"model: built and quantized Mixtral-8x7B ({layers} layers), {weights} weights "
        f"({'grouped, stacked codes' if grouped else 'per-expert linears'}) / {acts} activations, in {seconds:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card [{card}]")
    log(f"model: launches while building (weight quantization, not a main path): {json.dumps(dict(cuda_lib.LAUNCHES))}")
    model.build_seconds = seconds
    return model


def moe_readings(model, prompt, n, kv, floor: bool, tie_gap: float, tape_cls=RouteTape) -> dict:
    """``model_readings`` with the routing tape: each step the plain path runs
    first, layer by layer, recording its routing; the kernel path's layers,
    its end-to-end forward and the plain path with float64 attention replay
    it.  Adds the routing readings, of the kernel path and (``floor_``) of
    the plain path with float64 attention.  ``generate`` runs on its own
    routing, so a row is compared with it only until its own routing first
    parted from the plain path's (from there on their caches differ)."""
    from torchmx_tpu_torch.models.generate import generate
    from torchmx_tpu_torch.ops.backend import plain_path

    tokens = generate(model, prompt, n, kv_cache_config=kv)
    caches = model.init_cache(prompt.shape[0], (prompt.shape[1] + n + 127) // 128 * 128, kv)  # generate's length
    r = dict(logits=0.0, layer=0.0, lm_head=0.0, floor_logits=None, floor_layer=None, near_ties=0,
             decisive_flips=0, max_flipped_gap=0.0, generate_mismatch=0, finite=True)
    step_in, pos = prompt, 0
    with torch.inference_mode(), tape_cls() as tape:
        parted = torch.zeros(prompt.shape[0], dtype=torch.bool, device=prompt.device)
        for i in range(n):
            snap = [c.clone() for c in caches]
            snap64 = [c.clone() for c in caches] if floor else None
            tape.routes = []
            layer, head, layer_floor, ref = teacher_forced(model, step_in, snap, pos, floor, tape)
            tape.mode, tape.cursor, tape.who = "replay", 0, "kernel"
            tape.flipped_rows = parted
            got = model(step_in, caches=caches, cache_position=pos, last_only=True)[:, -1].float()
            tape.flipped_rows = None
            if floor:
                tape.cursor, tape.who = 0, "floor"
                with plain_path(), f64_plain_attention():
                    ref64 = model(step_in, caches=snap64, cache_position=pos, last_only=True)[:, -1]
                r["floor_logits"] = max(r["floor_logits"] or 0.0, _rel(ref64, ref))
                r["floor_layer"] = max(r["floor_layer"] or 0.0, layer_floor)
            tape.mode = None
            r["logits"] = max(r["logits"], _rel(got, ref))
            r["layer"], r["lm_head"] = max(r["layer"], layer), max(r["lm_head"], head)
            top2 = ref.topk(2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            decisive, differ = gap > tie_gap, got.argmax(-1) != ref.argmax(-1)
            r["near_ties"] += int((~decisive).sum())
            r["decisive_flips"] += int((differ & decisive).sum())
            r["max_flipped_gap"] = max(r["max_flipped_gap"], float((gap * differ).max()))
            r["generate_mismatch"] += int(((got.argmax(-1) != tokens[:, i]) & ~parted).sum())
            r["finite"] &= bool(torch.isfinite(got).all())
            pos += step_in.shape[1]
            step_in = tokens[:, i:i + 1]
    k, f = tape.stats["kernel"], tape.stats["floor"]
    r.update(route_mismatch=k["mismatch"], route_flips=k["flips"], routed_rows=k["rows"],
             max_flipped_route_gap=k["max_flip_gap"], rows_parted_from_generate=int(parted.sum()))
    if floor:
        r.update(floor_route_flips=f["flips"], floor_max_flipped_route_gap=f["max_flip_gap"])
    return r


def model_check_mixtral(dev, card) -> dict:
    """Kernel path against plain path on 2-layer Mixtral-8x7B-width models
    (seeded, router rows 0 and 1 tied), b=2, 16 greedy tokens over the int8
    seq cache, with the routing tape: fp4 grouped experts (with the seven
    planted faults of MIXTRAL_FAULTS, each of which must fail a gate) and
    e3m2 grouped experts; then the int8-weight grouped model against the
    int8 per-expert model (B6 in dense-exact mode): the same logits, bit for
    bit, at every step."""
    from torchmx_tpu_torch.models.generate import generate

    kv = quant_configs("int8")[2]
    prompt = torch.randint(0, MIXTRAL_8X7B["vocab_size"], (2, 64), generator=torch.Generator(dev).manual_seed(2),
                           device=dev)
    all_readings = {}
    for name, (weights, faults) in MIXTRAL_CHECKS.items():
        model = build_mixtral(dev, card, 2, seed=1, weights=weights, tied_router=True)
        tie_gap = GATES[name]["tie_gap"]
        readings = {"sound": moe_readings(model, prompt, 16, kv, True, tie_gap)}
        for fault in faults:
            with moe_fault(fault):
                readings[fault] = moe_readings(model, prompt, 16, kv, False, tie_gap)
        del model
        for fault, r in readings.items():
            log(f"model check {name} [{fault}]: 2 layers at Mixtral-8x7B width, b=2, 16 greedy tokens: "
                f"{json.dumps(r)} [{card}]")
        all_readings[name] = readings
    apply_gates(all_readings, GATES, card)
    outs = {}
    for grouped in (True, False):
        model = build_mixtral(dev, card, 2, seed=3, weights="int8", grouped=grouped)
        outs[grouped] = generate(model, prompt, 8, kv_cache_config=kv, return_logits=True)
        del model
    same = torch.equal(outs[True][0], outs[False][0]) and torch.equal(outs[True][1], outs[False][1])
    gap = (outs[True][1] - outs[False][1]).abs().max().item()
    log(f"model check: int8-weight grouped (B12) against per-expert (B6) Mixtral, 2 layers, b=2, prompt 64 + 8: "
        f"logits bit-identical {same} (max abs difference {gap}) [{card}]")
    if not same:
        raise AssertionError(f"the grouped int8 model differs from the per-expert one by {gap}")
    all_readings["int8 grouped vs per-expert"] = dict(bit_identical=same, max_abs_difference=gap)
    return all_readings


def run_mixtral(dev, card, layers: int) -> tuple:
    """The Mixtral main paths at full width and ``layers`` deep (32 unless
    cut): ``generate`` at b=1 and b=32 over the int8 seq cache, then the
    48-request engine stream with all its checks.  Returns (launches by path,
    launches per decode step by path, results)."""
    model = build_mixtral(dev, card, layers)
    build_s = model.build_seconds
    paths, per_step, results = {}, {}, {}
    paths["generate_mixtral"], res = run_slice(model, dev, card, "int8", weights="Mixtral fp4 grouped",
                                               want=mixtral_launches_per_step(layers))
    for b, r in res.items():
        per_step[f"mixtral_b{b}"] = r["launches_per_decode_step"]
        results[f"generate_b{b}"] = r
    results["engine"] = run_engine(model, dev, card, "int8", weights="mixtral")
    paths["engine_mixtral"] = results["engine"]["launches"]
    per_step["engine_mixtral"] = results["engine"]["launches_per_decode_step"]
    results["build_seconds"] = build_s
    del model
    torch.cuda.empty_cache()
    return paths, per_step, results


# -- phase 2: B13, B14, B7, the router's f32 mode, K4-fp6 ----------------------------------------

# moonshotai/Moonlight-16B-A3B config.json (model_type deepseek_v3), not cut.
MOONLIGHT_16B = dict(vocab_size=163840, hidden_size=2048, intermediate_size=11264, num_hidden_layers=27,
                     num_attention_heads=16, num_key_value_heads=16, q_lora_rank=None, kv_lora_rank=512,
                     qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128, n_routed_experts=64,
                     n_shared_experts=2, num_experts_per_tok=6, moe_intermediate_size=1408, n_group=1,
                     topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.446, first_k_dense_replace=1,
                     rope_theta=50000.0, rms_norm_eps=1e-5, max_position_embeddings=8192,
                     tie_word_embeddings=False)
MLA_FORMATS = ("bfloat16", "float8_e4m3", "float6_e3m2", "float6_e2m3", "int8", "float4_e2m1")
MLA_RAGGED = [1 + round(i * 1023 / 31) for i in range(32)]  # kv_len 1 .. 1024 over 32 rows
MLA_GK_KV = [65 + round(i * 127 / 31) for i in range(32)]  # kv_len 65 .. 192: generate's decode steps
# (label, b, n, L, sq, kv_len of each row): B13's calls on the Moonlight main path (decode over the
# engine's 1024-position cache at b=1 and 32, generate's decode at b=32 over its 256-position cache
# (prompt 64 + 128 tokens; one step's kv_len is one row here), an admission of 512, generate's
# prefill of 32 x 64) and bench.py:434's decode shape.
MLA_CASES = [("decode b=1 L=1024 kv=700", 1, 16, 1024, 1, [700]),
             ("decode b=32 L=1024 ragged", 32, 16, 1024, 1, MLA_RAGGED),
             ("decode b=32 L=256 kv=65-192", 32, 16, 256, 1, MLA_GK_KV),
             ("admission b=1 sq=512 L=1024", 1, 16, 1024, 512, [512]),
             ("prefill b=32 sq=64 L=256", 32, 16, 256, 64, [64] * 32),
             ("bench b=8 n=32 L=8192", 8, 32, 8192, 1, [8192] * 8)]
# B13's KV split: the visible prefix at and around the chunk boundaries of L = 1024 (S = 128, from
# cuda_mla.mla_chunk), at decode and in a prefill of 64 over a 256-position cache (S = 64).
MLA_SPLIT_CASES = [("decode b=4 L=1024 kv=S-1,S,S+1,2S+1", 4, 16, 1024, 1, [127, 128, 129, 257]),
                   ("prefill b=4 sq=64 L=256 kv=S-1,S,S+1,2S+1", 4, 16, 256, 64, [63, 64, 65, 129])]
MLA_INT8DOT_CASES = [c for c in MLA_CASES if c[4] == 1]


def _mla_case(dev, gen, b, n, L, sq, kv, elem, layout="seq"):
    """A latent cache of ``elem`` (bf16: ``MLACache``) filled with random
    latents and rope keys at every position, and queries at the last ``sq``
    of each row's ``kv`` visible positions: a dict of what the kernels take."""
    from torchmx_tpu_torch.models.deepseek import MLACache, MXMLACache

    lat = torch.randn(b, L, 512, generator=gen, device=dev).to(torch.bfloat16)
    rot = torch.randn(b, L, 64, generator=gen, device=dev).to(torch.bfloat16)
    if elem == "bfloat16":
        cache = MLACache.create(b, L, 512, 64, device=dev)
    else:
        cache = MXMLACache.create(b, L, 512, 64, elem, layout=layout, device=dev)
    cache.write(lat, rot, 0)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
    return dict(q_lat=(torch.randn(b, n, sq, 512, generator=gen, device=dev) * 0.5).to(torch.bfloat16),
                q_rot=(torch.randn(b, n, sq, 64, generator=gen, device=dev) * 0.5).to(torch.bfloat16),
                cache=cache, q_off=(kv_len - sq).clamp(min=0), kv_len=kv_len, sm=192 ** -0.5, elem=elem, n=n)


def _mla_args(c):
    """B13's arguments: the folded queries and the cache's four tensors."""
    b, n, sq, _ = c["q_lat"].shape
    cache = c["cache"]
    tensors = cache.buffers if c["elem"] != "bfloat16" else (cache.latent, cache.latent, cache.k_rot, cache.k_rot)
    fold = lambda q: q.transpose(1, 2).reshape(b, sq * n, q.shape[3]).contiguous()  # noqa: E731
    return (fold(c["q_lat"]), fold(c["q_rot"]), *tensors, c["q_off"], c["kv_len"], c["sm"], c["elem"], n)


def _mla_work(c):
    """(bytes, operations): each visible position's codes and scales once,
    q and the output once; the two dots over each query row's visible keys."""
    b, n, sq, _ = c["q_lat"].shape
    elem, layout = c["elem"], getattr(c["cache"], "layout", "seq")
    if elem == "bfloat16":
        per_pos = 2 * 576
    elif layout == "dmajor":
        per_pos = 576 + 2  # per-position scales
    else:
        per_pos = (288 if elem == "float4_e2m1" else 576) + 18
    nbytes, ops = b * n * sq * (576 + 512) * 2, 0
    for q_off, kv in zip(c["q_off"].tolist(), c["kv_len"].tolist()):
        nbytes += per_pos * min(kv, q_off + sq)
        ops += 2 * n * (576 + 512) * sum(min(q_off + j + 1, kv) for j in range(sq))
    return nbytes, ops


def _mla_dense(c):
    """The dequantized cache as SDPA's inputs: q = [q_lat | q_rot], K = [lat |
    rot], V = lat, the heads broadcast, and the boolean mask."""
    lat, rot = c["cache"].read()
    b, n, sq, _ = c["q_lat"].shape
    q = torch.cat([c["q_lat"], c["q_rot"]], dim=-1)
    k = torch.cat([lat, rot], dim=-1)[:, None].expand(b, n, -1, -1)
    v = lat.contiguous()[:, None].expand(b, n, -1, -1)
    pos = c["q_off"][:, None] + torch.arange(sq, device=q.device)[None]
    j = torch.arange(lat.shape[1], device=q.device)
    mask = ((j <= pos[..., None]) & (j < c["kv_len"][:, None, None]))[:, None]
    return q, k, v, mask


def _mla_exact(c):
    """Float64 attention over the dequantized cache, p not rounded."""
    q, k, v, mask = _mla_dense(c)
    s = (q.double() @ k.double().transpose(-1, -2)) * c["sm"]
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v.double()


def _mla_library(c):
    """(the SDPA call over the dequantized cache, the backend that serves it):
    the memory-efficient kernel where it takes the shape (head dim 576 is
    past flash attention's limit), else the math one."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, mask = _mla_dense(c)
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=c["sm"])
        try:
            call()
            return call, backend.name
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend takes the MLA shape")


# B13 against its plain version: the worst row's relative L2 error, beside abs <= 2e-2.  Readings
# (NVIDIA H100 80GB HBM3, 700 W, every MLA_CASES and MLA_SPLIT_CASES shape in six formats): sound
# abs <= 7.8e-3 (one bf16 ulp) and row rel <= 3.6e-3; a combine that drops the last live chunk of
# one position (kv = S + 1, 2S + 1, 3S + 1), one batch row alone: abs >= 1.2e-2 but row rel >=
# 4.7e-2, >= 1.3e-1 over each case.
B13_ROW_REL = 1.2e-2


def check_mla_kernel(dev, timer, gen):
    """B13 against its plain version (abs <= 2e-2, and the worst row's
    relative L2 error <= B13_ROW_REL) in all six cache formats at
    every MLA_CASES and MLA_SPLIT_CASES shape; B13 over the int8 cache
    against B13 bf16 over the dequantized latent (the same decoded values:
    abs <= 2e-2, and printed
    whether bit for bit); timed over the int8 cache (the main path's) at
    every shape beside its plain version, SDPA and the bound, and over the
    other formats at decode b=32.  Returns (entry, rows)."""
    from torchmx_tpu_torch.models.deepseek import MLACache
    from torchmx_tpu_torch.ops import cuda_mla

    worst, rows = 0.0, []
    for label, b, n, L, sq, kv in MLA_CASES + MLA_SPLIT_CASES:
        for elem in MLA_FORMATS:
            c = _mla_case(dev, gen, b, n, L, sq, kv, elem)
            args = _mla_args(c)
            out = cuda_mla.mx_mla_attention(*args)
            ref = cuda_mla.mx_mla_attention_plain(*args)
            err, rel = (out.float() - ref.float()).abs().max().item(), worst_row_rel(out, ref)
            worst = max(worst, err)
            log(f"B13 mx_mla_attention {label} {elem}: max abs err {err:.3e}, worst row rel L2 {rel:.3e}")
            if not (err <= 2e-2 and rel <= B13_ROW_REL):
                raise AssertionError(f"B13 {label} {elem}: abs err {err}, worst row rel L2 {rel}")
            if elem == "int8":
                lat, rot = c["cache"].read()
                dense = dict(c, cache=MLACache(lat.contiguous(), rot.contiguous()), elem="bfloat16")
                via_bf16 = cuda_mla.mx_mla_attention(*_mla_args(dense))
                d = (out.float() - via_bf16.float()).abs().max().item()
                log(f"B13 {label}: int8 cache against bf16 over the dequantized latent: max abs diff {d:.3e}, "
                    f"bit-identical {torch.equal(out, via_bf16)}")
                if not d <= 2e-2:
                    raise AssertionError(f"B13 {label}: int8 against bf16 over the same values differs by {d}")
            if elem == "int8" or label.startswith("decode b=32"):
                t_b, by = bound(*_mla_work(c))
                lib, backend = _mla_library(c)
                row = dict(case=label, elem=elem, ms=timer(lambda: cuda_mla.mx_mla_attention(*args)),
                           plain_ms=timer(lambda: cuda_mla.mx_mla_attention_plain(*args), reps=3),
                           library_ms=timer(lib, reps=5), library_backend=backend, bound_ms=t_b, bound_by=by)
                log("B13 timing", json.dumps(row))
                rows.append(row)
            del c, args
    pick = next(r for r in rows if r["case"].startswith("decode b=32") and r["elem"] == "int8")
    return dict(name="mx_mla_attention", route="cuda", source="torchmx_tpu_torch/csrc/mx_mla.cu",
                replaces="torchmx_tpu/ops/pallas_mla.py:75",
                shape="decode b=32 n=16 r=512 dr=64 L=1024 kv_len 1-1024, int8 seq latent", max_abs_err=worst,
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}), rows


# B14 against its plain version: the worst row's relative L2 error, beside abs <= 2e-2.  Readings
# (tools/gate_readings.py --kernel b14 and phase 2, NVIDIA H100 80GB HBM3, 700 W, PERF.md PR 18):
# sound row rel <= 1.89e-3; a combine that drops the last live tile of one position (kv = lt + 1,
# 2 lt + 1), one batch row alone: >= 1.33e-2 (L = 8192, kv 2049: one position of 2049).
B14_ROW_REL = 5e-3


def b14_edge_cases():
    """B14's tiles (JAX's ``_pick_lt(L)``) and its CTAs' shares
    (``cuda_mla.b14_split``) at and around their edges over L = 256, 1024 and
    8192, with a row that sees no key; and 40 heads (two head groups) at L =
    1024.  Each a (label, b, n, L, sq, kv_len of each row) of MLA_CASES'
    form."""
    from torchmx_tpu_torch.ops.cuda_mla import b14_split

    out = []
    for L in (256, 1024, 8192):
        lt, P = b14_split(L)
        kv = sorted({e for e in (P - 1, P + 1, lt - 1, lt, lt + 1, 2 * lt - 1, 2 * lt + 1, L) if e <= L} | {0})
        out.append((f"decode b={len(kv)} L={L} lt={lt} P={P} kv={','.join(map(str, kv))}", len(kv), 16, L, 1, kv))
    out.append(("decode b=3 n=40 L=1024 kv=1,513,1000", 3, 40, 1024, 1, [1, 513, 1000]))
    return out


def _b14_args(c):
    return (c["q_lat"], c["q_rot"], *c["cache"].buffers, c["q_off"], c["kv_len"], c["sm"])


def check_b14_dropped_tile(dev, gen):
    """The planted combine fault (the last live tile of a row dropped) at
    kv_len = lt + 1 and 2 lt + 1 over L = 1024 and 8192, one batch row
    alone: the sound kernel passes the row gate, the fault fails it.
    Returns the readings."""
    from torchmx_tpu_torch.ops import cuda_mla

    out = []
    for L in (1024, 8192):
        lt, _ = cuda_mla.b14_split(L)
        for kv in (lt + 1, 2 * lt + 1):
            args = _b14_args(_mla_case(dev, gen, 1, 16, L, 1, [kv], "int8", layout="dmajor"))
            ref = cuda_mla.mx_mla_attention_int8dot_plain(*args)
            sound = worst_row_rel(cuda_mla.mx_mla_attention_int8dot(*args), ref)
            fault = worst_row_rel(cuda_mla.mx_mla_attention_int8dot(*args, drop_last_tile=True), ref)
            log(f"B14 dropped-tile fault L={L} kv={kv}: worst row rel L2 sound {sound:.3e}, fault {fault:.3e}")
            if not sound <= B14_ROW_REL < fault:
                raise AssertionError(f"B14 L={L} kv={kv}: the row gate must pass the kernel ({sound}) and fail "
                                     f"the dropped tile ({fault})")
            out.append(dict(L=L, kv_len=kv, sound_row_rel=sound, fault_row_rel=fault))
    return out


def check_b14_q_codes(dev, gen):
    """B14's prologue quantizes q with the per-row kernel's arithmetic: its
    codes and scales (through ``q_out``) equal ``quantize_q_rows``' (the
    per-row kernel on the card) bit for bit, over q holding zeros,
    subnormals and large values, at 16 and 40 heads."""
    from torchmx_tpu_torch.ops import cuda_mla

    for n in (16, 40):
        c = _mla_case(dev, gen, 3, n, 1024, 1, [700, 1, 1024], "int8", layout="dmajor")
        for q in (c["q_lat"], c["q_rot"]):
            q.view(-1)[::7] = 0
            q.view(-1)[1::11] *= 2.0 ** -120
            q.view(-1)[2::13] *= 2.0 ** 100
        want = cuda_mla.quantize_q_rows(c["q_lat"], c["q_rot"], c["sm"])
        got = tuple(torch.empty_like(t) for t in want)
        cuda_mla.mx_mla_attention_int8dot(*_b14_args(c), q_out=got)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"B14 n={n}: the prologue's q codes or scales differ from the per-row kernel's")
    log("B14 prologue: q codes and scales equal the per-row kernel's at n = 16 and 40")
    return dict(q_codes_equal_rows_kernel=True)


def check_mla_int8dot_kernel(dev, timer, gen):
    """B14 over the int8 d-major latent against its plain version (abs <=
    2e-2 and the worst row's relative L2 error <= B14_ROW_REL) at its decode
    shapes and at the edges of its tiles and shares (``b14_edge_cases``), a
    row with no visible key exactly 0, two launches the same bytes; against
    float64 attention over the dequantized cache (SQNR > 30 dB where the
    plain version, JAX's arithmetic, reaches it, else within 0.1 dB of the
    plain version's); the dropped-tile fault caught by the row gate; its
    prologue's q codes the per-row kernel's.  Timed at the decode shapes as
    the path calls it (q quantized inside) beside its plain version, SDPA
    and the bound.  Returns (entry, rows)."""
    from torchmx_tpu_torch.ops import cuda_mla

    worst, worst_rel, rows = 0.0, 0.0, []
    for case in MLA_INT8DOT_CASES + b14_edge_cases():
        label, b, n, L, sq, kv = case
        c = _mla_case(dev, gen, b, n, L, sq, kv, "int8", layout="dmajor")
        args = _b14_args(c)
        out = cuda_mla.mx_mla_attention_int8dot(*args)
        torch.cuda.synchronize()
        ref = cuda_mla.mx_mla_attention_int8dot_plain(*args)
        err, rel = (out.float() - ref.float()).abs().max().item(), worst_row_rel(out, ref)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        exact = _mla_exact(c)
        db, db_plain = sqnr_db(out, exact), sqnr_db(ref, exact)
        log(f"B14 mx_mla_attention_int8dot {label}: max abs err {err:.3e}, worst row rel L2 {rel:.3e} vs plain at "
            f"JAX's tile {cuda_mla.b14_split(L)[0]}; SQNR {db:.2f} dB (plain {db_plain:.2f}) against exact attention")
        if not (err <= 2e-2 and rel <= B14_ROW_REL) or not torch.isfinite(out.float()).all():
            raise AssertionError(f"B14 {label}: abs err {err}, worst row rel L2 {rel}")
        # Above 30 dB (the JAX package's own bound for its int8-dot attention); where JAX's arithmetic
        # itself stays below it (the plain version: JAX's bit for bit on the CPU), within 0.1 dB of it.
        if not (db > 30 or db_plain <= 30 and db >= db_plain - 0.1):
            raise AssertionError(f"B14 {label}: SQNR {db:.2f} dB against exact attention (plain {db_plain:.2f} dB)")
        empty = [i for i, k in enumerate(kv) if k == 0]
        if empty and out[empty].float().abs().max().item() != 0.0:
            raise AssertionError(f"B14 {label}: a row with no visible key must output 0")
        if not torch.equal(out, cuda_mla.mx_mla_attention_int8dot(*args)):
            raise AssertionError(f"B14 {label}: two launches on the same inputs differ")
        del exact
        if case not in MLA_INT8DOT_CASES:
            continue
        nbytes, ops = _mla_work(c)
        t_b, by = bound(nbytes, ops, INT8_OPS)
        lib, backend = _mla_library(c)
        row = dict(case=label, ms=timer(lambda: cuda_mla.mx_mla_attention_int8dot(*args)),  # q's quantization inside
                   plain_ms=timer(lambda: cuda_mla.mx_mla_attention_int8dot_plain(*args), reps=3),
                   library_ms=timer(lib, reps=5), library_backend=backend, bound_ms=t_b, bound_by=by,
                   max_abs_err=err, worst_row_rel=rel, sqnr_db=db, sqnr_db_plain=db_plain)
        log("B14 timing", json.dumps(row))
        rows.append(row)
        del c, args
    dropped = check_b14_dropped_tile(dev, gen)
    prologue = check_b14_q_codes(dev, gen)
    pick = next(r for r in rows if r["case"].startswith("decode b=32 L=1024"))
    return dict(name="mx_mla_attention_int8dot", route="cuda", source="torchmx_tpu_torch/csrc/mx_mla_int8dot.cu",
                replaces="torchmx_tpu/ops/pallas_mla.py:343",
                shape="decode b=32 n=16 r=512 dr=64 L=1024 kv_len 1-1024, int8 d-major latent (q quantized in the "
                      "kernel's prologue)", max_abs_err=worst, worst_row_rel=worst_rel, row_rel_gate=B14_ROW_REL,
                dropped_tile=dropped, prologue=prologue,
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}), rows


# (label, b, s or n, L, positions or None for a q pair): the per-row quantize kernel's calls (B14's
# q pair at decode b=1 and 32 as its plain version and quantize_q_rows take it; on the Moonlight int8
# d-major path the latent write at decode b=32 over
# the engine's 1024 positions with one slot clamped, an admission of 512 and generate's prefill of 32 x 64).
ROWS_CASES = [("B14 q pair b=1 n=16", 1, 16, None, None), ("B14 q pair b=32 n=16", 32, 16, None, None),
              ("latent write decode b=32 s=1 L=1024", 32, 1, 1024, [r - 1 for r in MLA_RAGGED[:-1]] + [1030]),
              ("latent write admission b=1 s=512 L=1024", 1, 512, 1024, [600]),
              ("latent write prefill b=32 s=64 L=256", 32, 64, 256, [0] * 32)]


def check_quantize_rows_kernel(dev, timer, gen):
    """The per-row quantize kernel (``mx_quantize_rows``) against its plain
    version, bit for bit (codes, scales, the d-major buffers around the
    written columns): over all 2^16 bf16 patterns as rows of 512 and of 64 in
    the four formats it takes, in both output modes (the d-major one at
    per-row starts, two of which clamp), and at every ROWS_CASES shape; timed
    there beside its plain version and the bound.  Returns (entry, rows)."""
    from torchmx_tpu_torch.models.deepseek import MXMLACache
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    def compare(label, elem, x1, x2, sm=1.0, L=None, pos=None):
        if L is None:
            got, ref = cq.mx_quantize_rows(x1, x2, elem, sm), cq.mx_quantize_rows_plain(x1, x2, elem, sm)
        else:
            caches = [MXMLACache.create(x1.shape[0], L, x1.shape[2], x2.shape[2], elem, layout="dmajor", device=dev)
                      for _ in range(2)]
            cq.mx_quantize_rows(x1, x2, elem, out=caches[0].buffers, pos=pos)
            cq.mx_quantize_rows_plain(x1, x2, elem, out=caches[1].buffers, pos=pos)
            got, ref = caches[0].buffers, caches[1].buffers
        bad = sum(int((g.view(torch.uint8) != r.view(torch.uint8)).sum()) for g, r in zip(got, ref))
        log(f"mx_quantize_rows {elem} {label}: {bad} mismatching bytes")
        if bad:
            raise AssertionError(f"mx_quantize_rows {elem} {label}: differs from its plain version")

    every = all_bf16_blocks(dev).reshape(-1)
    x512 = every.repeat(8).reshape(1024, 512)  # a row: 512 neighbouring patterns, so its exponents vary
    x64 = every.reshape(1024, 64)
    starts = torch.tensor([0, 256, 300, -5], dtype=torch.int32, device=dev)  # 300 and -5 clamp to 256 and 0
    for elem in cq.ROW_FORMATS:
        compare("all bf16 patterns, rows of 512 and 64", elem, x512, x64)
        compare("all bf16 patterns, d-major, starts 0 / 256 / 300 / -5 over L=512", elem,
                x512.reshape(4, 256, 512), x64.reshape(4, 256, 64), L=512, pos=starts)
    sm = 192 ** -0.5  # Moonlight's qk_head_dim
    rows = []
    for label, b, sn, L, pos in ROWS_CASES:
        x1 = torch.randn(b, sn, 512, generator=gen, device=dev).to(torch.bfloat16)
        x2 = torch.randn(b, sn, 64, generator=gen, device=dev).to(torch.bfloat16)
        n = b * sn
        if L is None:
            compare(label, "int8", x1, x2, sm)
            call = lambda: cq.mx_quantize_rows(x1, x2, "int8", sm)  # noqa: E731
            plain = lambda: cq.mx_quantize_rows_plain(x1, x2, "int8", sm)  # noqa: E731
            nbytes = n * (3 * 576 + 8)
        else:
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            for elem in cq.ROW_FORMATS:
                compare(label, elem, x1, x2, L=L, pos=p)
            cache = MXMLACache.create(b, L, 512, 64, "int8", layout="dmajor", device=dev)
            call = lambda: cq.mx_quantize_rows(x1, x2, "int8", out=cache.buffers, pos=p)  # noqa: E731
            plain = lambda: cq.mx_quantize_rows_plain(x1, x2, "int8", out=cache.buffers, pos=p)  # noqa: E731
            nbytes = n * (3 * 576 + 2) + 4 * b
        t_b, by = bound(nbytes)
        row = dict(case=label, ms=timer(call), plain_ms=timer(plain, reps=5), bound_ms=t_b, bound_by=by,
                   library_ms=None)
        log("mx_quantize_rows timing", json.dumps(row))
        rows.append(row)
    pick = next(r for r in rows if r["case"].startswith("latent write decode"))
    return dict(name="mx_quantize_rows", route="cuda", source="torchmx_tpu_torch/csrc/mx_quantize.cu",
                replaces="torchmx_tpu/models/deepseek.py:316",  # jnp quantize_mx at block = w (also pallas_mla.py:522)
                shape="int8 latent write, decode b=32 s=1 L=1024, rows of 512 + 64", max_abs_err=0.0,
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}), rows


FP4_PAIR_SHAPE = (2816, 2048)  # (K, N) of Moonlight's shared-expert down_proj: K % 512 != 0 keeps the pair layout
FP4_PAIR_MS = (1, 32, 64, 2048)  # decode b=1 and 32, prefill of 64 tokens at b=1 and 32
# B7 beyond the main path's shape: a short K the planes pad (K % 128 != 0),
# Qwen2-0.5B's gate/up (K 896) and down (K 4864, N 896 = 7 x 128: a half
# column tile), the pair weights of ROADMAP A.2.
FP4_PAIR_EXTRA = {"K=160": (160, 2048), "Qwen2-0.5B gate/up": (896, 4864), "Qwen2-0.5B down": (4864, 896)}
PAIR_ACTS = (None, "float8_e4m3", "int8")


def b7_parts(timer, dev, x, w, act, row):
    """A B7 timing row's parts, added to ``row``: the kernel alone on x in
    plane order, K2's plane mode on the call's x, the split reduce where the
    plan has a second pass, and the plan."""
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    (M, K), N = x.shape, w.shape[1]
    plan = kf.plan_pair(M, N, K, cm.sm_count(dev))
    xp = cq.mx_fake_quantize_planes(x, act)
    out, ws = kf.b7_kernel(xp, w.data, w.scale_e8m0, K, plan)
    row.update(kernel_ms=timer(lambda: kf.b7_kernel(xp, w.data, w.scale_e8m0, K, plan)),
               k2_ms=timer(lambda: cq.mx_fake_quantize_planes(x, act)),
               reduce_ms=timer(lambda: kf.b7_reduce(ws, out)) if ws is not None else None,
               plan=dict(splits=plan.splits, walk=plan.walk))
    log("B7 parts", json.dumps({k: row.get(k) for k in ("shape", "M", "act_fq", "kernel_ms", "k2_ms", "reduce_ms",
                                                         "plan")}))
    return row


def every_pair_weight(dev):
    """A (K = 512, N = 256) pair weight holding every (code, scale) pair:
    code k % 16 at K row k; scale row r of column n is n for even r and
    (n + 128) % 256 for odd r, so each 32-row tile of packed bytes spans two
    MX blocks, and the warp's 16 columns are safe in one and unsafe in the
    other (scales 16-127 against 144-255).  Returns (bytes, scales)."""
    codes = (torch.arange(512, device=dev, dtype=torch.int32) % 16).reshape(512, 1).expand(512, 256)
    n = torch.arange(256, device=dev, dtype=torch.int32).reshape(1, 256)
    scales = torch.cat([n, (n + 128) % 256]).repeat(8, 1).to(torch.uint8).contiguous()
    return ((codes[0::2] << 4) | codes[1::2]).to(torch.uint8).contiguous(), scales


def check_pair_decode(dev):
    """Every (code, scale) pair through B7's decode, bit for bit: x the
    identity, so the output is the decoded weight (NaN as NaN), at M = 64
    (the first packed tile) and 512 (all)."""
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf

    data, scales = every_pair_weight(dev)
    eye = torch.eye(512, device=dev, dtype=torch.bfloat16)
    for M in (64, 512):
        x = eye[:M].contiguous()
        check_decode_bits("mx_matmul_fp4_pair", "float4_e2m1", kf.mx_matmul_fp4_pair(x, data, scales),
                          kf.mx_matmul_fp4_pair_plain(x, data, scales))


def check_pair_planes(dev, gen):
    """K2's plane mode against its plain version, bit for bit: all 2^16 bf16
    patterns as rows of 64 and 96 (the planes padded) in each mode, and the
    main path's activations (Moonlight's shared down_proj at decode and
    prefill, Qwen2-0.5B's widths)."""
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    x_all = all_bf16_blocks(dev).reshape(-1)
    cases = [("all bf16 patterns, rows of 64", x_all.reshape(-1, 64)),
             ("all bf16 patterns, rows of 96", x_all[:65472].reshape(-1, 96))]
    for M, K in ((32, 2816), (2048, 2816), (32, 896), (32, 4864), (33, 160)):
        cases.append((f"({M}, {K})", (torch.randn(M, K, generator=gen, device=dev)
                                      * torch.exp2(torch.randn(M, K, generator=gen, device=dev) * 3)).to(torch.bfloat16)))
    for label, x in cases:
        for act in PAIR_ACTS:
            got, want = cq.mx_fake_quantize_planes(x, act), cq.mx_fake_quantize_planes_plain(x, act)
            differ = int(((got.view(torch.int16) != want.view(torch.int16)) & ~(got.isnan() & want.isnan())).sum())
            log(f"K2 plane mode act={act} {label}: {differ} of {got.numel()} values differ from the plain version's")
            if differ:
                raise AssertionError(f"K2's plane mode act={act} {label}: {differ} values differ")


def check_fp4_pair_kernel(dev, timer, gen):
    """B7 against its plain version (rel <= 1e-2) at the shared-expert down
    shape and the shapes of FP4_PAIR_EXTRA, with act fq None, fp8 and int8,
    at every main-path M; the pair decode on every (code, scale) pair and
    K2's plane mode, bit for bit; timed with fp8 act fq as the path calls it
    (K2's plane mode inside) beside its plain version, ``torch.matmul`` with a
    bf16 weight and the bound, and apart the kernel alone, K2 and the split
    reduce (every M at the down shape, M = 32 and 2048 at the others).
    Returns (entry, rows)."""
    from torchmx_tpu_torch.mx_array import MXTensor
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf

    worst, rows = 0.0, []
    for label, (K, N) in {"shared-expert down_proj": FP4_PAIR_SHAPE, **FP4_PAIR_EXTRA}.items():
        w = MXTensor.to_mx((torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16),
                           "float4_e2m1").T
        assert w.fp4_pack == "pair"
        w_bf16 = kf.dequantize_fp4_pair(w.data, w.scale_e8m0)
        for M in FP4_PAIR_MS:
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            for act in PAIR_ACTS:
                o = kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, act)
                r = kf.mx_matmul_fp4_pair_plain(x, w.data, w.scale_e8m0, act)
                err = (o.float() - r.float()).abs().max().item()
                rel = err / r.float().abs().max().item()
                worst = max(worst, err)
                log(f"B7 mx_matmul_fp4_pair {label} M={M} N={N} K={K} act_fq={act}: rel err {rel:.3e}")
                if not rel <= 1e-2:
                    raise AssertionError(f"B7 {label} M={M} act_fq={act}: rel {rel}")
            if (K, N) != FP4_PAIR_SHAPE and M not in (32, 2048):
                continue
            act = "float8_e4m3"
            t_b, by = bound(2 * M * K + K * N / 2 + K * N / 32 + 2 * M * N, 2 * M * N * K)
            row = dict(shape=label, M=M, N=N, K=K, act_fq=act,
                       ms=timer(lambda: kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, act)),
                       plain_ms=timer(lambda: kf.mx_matmul_fp4_pair_plain(x, w.data, w.scale_e8m0, act), reps=5),
                       library_ms=timer(lambda: torch.matmul(x, w_bf16)), bound_ms=t_b, bound_by=by)
            b7_parts(timer, dev, x, w, act, row)
            log("B7 timing", json.dumps(row))
            rows.append(row)
        del w_bf16
    check_pair_decode(dev)
    check_pair_planes(dev, gen)
    pick = next(r for r in rows if r["M"] == 32 and (r["K"], r["N"]) == FP4_PAIR_SHAPE)
    K, N = FP4_PAIR_SHAPE
    return dict(name="mx_matmul_fp4_pair", route="cuda", source="torchmx_tpu_torch/csrc/mx_matmul.cu",
                replaces="torchmx_tpu/ops/pallas_matmul.py:473",
                shape=f"M=32 N={N} K={K} act_fq=float8_e4m3 (K2's plane mode inside)",
                tolerance="rel <= 1e-2 (max abs over max abs)", max_abs_err=worst,
                **{k: pick[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms", "k2_ms",
                                        "reduce_ms")}), rows


# (E, H) of the f32 router: Moonlight's and DeepSeek-V3's (256 experts over hidden 7168).
ROUTER_F32_SHAPES = {"Moonlight E=64 H=2048": (64, 2048), "DeepSeek-V3 E=256 H=7168": (256, 7168)}


def check_router_f32(dev, timer, gen):
    """The router kernel's f32 mode against its plain version, bit for bit (0
    ulp), at E=64 and 256 and the main path's token counts; timed beside its
    plain version, the f32 ``F.linear`` and the bound.  Returns rows."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_moe

    rows = []
    for label, (E, H) in ROUTER_F32_SHAPES.items():
        w = (torch.randn(E, H, generator=gen, device=dev) * H ** -0.5).to(torch.bfloat16)
        wf = w.float()
        for T in ROUTER_T:
            x = torch.randn(T, H, generator=gen, device=dev).to(torch.bfloat16)
            out = cuda_moe.mx_router_logits(x, w, f32=True)
            ref = cuda_moe.mx_router_logits_plain(x, w, f32=True)
            differ = int((out != ref).sum())
            log(f"mx_router_logits f32 {label} T={T}: {differ} of {out.numel()} logits differ from the plain version's")
            if differ:
                raise AssertionError(f"the router's f32 mode {label} T={T}: {differ} logits differ from the plain version")
            t_b, by = bound(2 * T * H + 2 * E * H + 4 * T * E, 2 * T * E * H)
            row = dict(shape=label, T=T, ms=timer(lambda: cuda_moe.mx_router_logits(x, w, f32=True)),
                       plain_ms=timer(lambda: cuda_moe.mx_router_logits_plain(x, w, f32=True), reps=3),
                       library_ms=timer(lambda: F.linear(x.float(), wf)), bound_ms=t_b, bound_by=by)
            log("mx_router_logits f32 timing", json.dumps(row))
            rows.append(row)
    return rows


K4_FP6_CASES = [("decode b=32 L=256 kv=192", 32, 256, 1, [192] * 32), ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32)]


def check_k4_fp6(dev, timer, gen):
    """K4 over seq-layout fp6 caches (e3m2, e2m3) at the Llama main path's
    decode and prefill shapes against its plain version under its gate
    (``check_k4_case``), timed at decode.  Returns (worst error, rows)."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    worst, rows = 0.0, []
    for elem in ("float6_e3m2", "float6_e2m3"):
        for label, b, L, sq, kv in K4_FP6_CASES:
            args = _attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, elem)
            worst = max(worst, check_k4_case(f"{elem} {label}", args)[0])
            if sq == 1:
                t_b, by = bound(*_attn_work(args))
                row = dict(case=f"{elem} {label}", ms=timer(lambda: ca.mx_cached_attention(*args)),
                           plain_ms=timer(lambda: ca.mx_cached_attention_plain(*args), reps=5), bound_ms=t_b, bound_by=by)
                log("K4-fp6 timing", json.dumps(row))
                rows.append(row)
    return worst, rows


def check_slice6_row_invariance(dev) -> dict:
    """B7 (fp8 act fq by K2's plane mode) and the router's
    f32 mode (Moonlight's E=64, H=2048) at every row count from 1 to 511: a
    row's bytes must not depend on the count."""
    from torchmx_tpu_torch.mx_array import MXTensor
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops import cuda_moe

    gen = torch.Generator(dev).manual_seed(9876)
    K, N = FP4_PAIR_SHAPE
    w = MXTensor.to_mx((torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16), "float4_e2m1").T
    x = torch.randn(512, K, generator=gen, device=dev).to(torch.bfloat16)
    full = kf.mx_matmul_fp4_pair(x, w.data, w.scale_e8m0, "float8_e4m3")
    bad = [f"B7 rows={k}" for k in range(1, 512)
           if not torch.equal(kf.mx_matmul_fp4_pair(x[:k].contiguous(), w.data, w.scale_e8m0, "float8_e4m3"), full[:k])]
    gw = (torch.randn(64, 2048, generator=gen, device=dev) * 2048 ** -0.5).to(torch.bfloat16)
    xr = torch.randn(512, 2048, generator=gen, device=dev).to(torch.bfloat16)
    full = cuda_moe.mx_router_logits(xr, gw, f32=True)
    bad += [f"router f32 rows={k}" for k in range(1, 512)
            if not torch.equal(cuda_moe.mx_router_logits(xr[:k], gw, f32=True), full[:k])]
    if bad:
        raise AssertionError(f"a row's result depends on the number of rows: {bad[:20]} ({len(bad)} counts)")
    log("row invariance: B7 (K=2816 N=2048, fp8 act fq) and the router's f32 mode (E=64 H=2048) give every row the "
        "same bytes at every count from 1 to 511")
    return dict(counts="1-511", b7=FP4_PAIR_SHAPE, router_f32=(64, 2048))


# -- DeepSeek-V3 MLA and the noaux-tc MoE at Moonlight-16B-A3B's width -----------------------------


def build_moonlight(dev, card, layers: int, seed: int = 0, weights="float4_e2m1", acts="float8_e4m3",
                    grouped: bool = True, tied_router: bool = False):
    """Moonlight-16B-A3B at full width, ``layers`` deep (27 unless cut):
    seeded random bf16 weights made on the card and quantized layer by layer
    (the routed experts as stacked codes for B12, re-coded exactly as MXINT8
    for fp4, unless ``grouped`` is False), each MoE layer's correction bias
    random (std 0.05).  ``tied_router`` makes router rows 0 and 1 and their
    biases equal, so that the tie-break is exercised."""
    from torchmx_tpu_torch.models.deepseek import DeepseekV3Config, DeepseekV3ForCausalLM, DeepseekV3MoE
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.quant_api import build_quantized

    qa, qm, _ = quant_configs(weights=weights, acts=acts)
    cfg = DeepseekV3Config(**{**MOONLIGHT_16B, "num_hidden_layers": layers})
    gen = torch.Generator(dev).manual_seed(seed)

    def prepare(layer):
        if isinstance(layer.mlp, DeepseekV3MoE):
            layer.mlp.grouped, layer.mlp.grouped_tm = grouped, GROUPED_TM
            bias = layer.mlp.gate.e_score_correction_bias
            bias.copy_(torch.randn(bias.shape, generator=gen, device=dev) * 0.05)
            if tied_router:
                layer.mlp.gate.weight[1] = layer.mlp.gate.weight[0]
                bias[1] = bias[0]

    cuda_lib.reset_launch_counts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        model = build_quantized(DeepseekV3ForCausalLM, cfg, qa, qm, dev, gen, prepare)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    layouts = sorted({(m.weight.elem_dtype.name, m.weight.fp4_pack) for m in model.modules()
                      if hasattr(getattr(m, "weight", None), "fp4_pack")})
    log(f"model: built and quantized Moonlight-16B-A3B ({layers} layers), {weights} weights "
        f"({'grouped, stacked codes' if grouped else 'per-expert linears'}, linear layouts {layouts}) / {acts} "
        f"activations, in {seconds:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card [{card}]")
    log(f"model: launches while building (weight quantization, not a main path): {json.dumps(dict(cuda_lib.LAUNCHES))}")
    model.build_seconds = seconds
    return model


def moonlight_launches_per_step(cfg, int8dot: bool = False) -> dict:
    """Kernel launches of one decode step of the MX DeepSeek model (fp4
    weights, fp8 activations, grouped experts), from its structure: per
    layer q_proj (or q_a / q_b), kv_a_proj and o_proj on K3 (input widths
    multiples of 512), kv_a_layernorm and the two layer norms; per dense
    layer gate / up / down on K3 (or B7 where K % 512 != 0); per MoE layer
    the router, B12 x 3, K2 on x_sorted and on the SwiGLU output, the shared
    experts' gate / up and down (K3 or B7); lm_head; the final norm; K2
    before each K3 (one for the first query projection and kv_a_proj, one
    for the shared experts' gate / up pair; a dense layer's gate / up take
    theirs in the post-attention norm's launch) and before each B7 (its
    plane mode, never shared);
    B13 and K1 (the latent write)
    per layer, or with the int8-dot flag B14 (which quantizes its query
    itself) and the per-row quantize kernel (the d-major latent write)."""
    layers, dense = cfg.num_hidden_layers, min(cfg.first_k_dense_replace, cfg.num_hidden_layers)
    moe = layers - dense
    c = collections.Counter()

    def linear(k_in, n=1, k2=None):
        """n launches of a linear: K3 where K % 512 == 0, with K2 first (k2
        launches for the n where they share one x, else n), else B7 with
        its own K2."""
        if k_in % 512 == 0:
            c["mx_matmul_fp4_halves"] += n
            c["mx_fake_quantize"] += n if k2 is None else k2
        else:
            c["mx_matmul_fp4_pair"] += n
            c["mx_fake_quantize"] += n

    h, n_heads = cfg.hidden_size, cfg.num_attention_heads
    linear(h, 2 * layers, k2=layers)  # q_proj (or q_a_proj) and kv_a_proj_with_mqa share one K2
    if cfg.q_lora_rank:
        linear(cfg.q_lora_rank, layers)
        c["mx_rmsnorm"] += layers
    linear(n_heads * cfg.v_head_dim, layers)  # o_proj
    linear(h, 2 * dense, k2=0)  # gate / up share one K2, in the post-attention norm's launch
    linear(cfg.intermediate_size, dense)
    shared = cfg.moe_intermediate_size * cfg.n_shared_experts
    linear(h, 2 * moe, k2=moe)
    linear(shared, moe)
    linear(h)  # lm_head
    c["mx_rmsnorm"] += 3 * layers + 1
    c.update(mx_router_logits=moe, mx_grouped_matmul=3 * moe, mx_fake_quantize=2 * moe)
    if int8dot:
        c.update(mx_mla_attention_int8dot=layers, mx_quantize_rows=layers)
    else:
        c.update(mx_mla_attention=layers, mx_quantize=layers)
    return dict(c)


DEEPSEEK_FAULTS = ("B13 reads the next position's scale", "B13 takes V from the rope key",
                   "B13's combine drops the last live chunk", "B7 with its nibbles swapped",
                   "B7 reads block 2j's scale for block 2j + 1", "K2 writes B7's odd plane first",
                   "the correction bias added to the weights, not the choice", "routed_scaling_factor dropped",
                   "the shared experts dropped",
                   "an expert choice flipped at a gap above 5e-2")
DEEPSEEK_FAULTS_DMAJOR = ("mx_quantize_rows writes the latent one position late",)
# The DeepSeek model checks: name -> (cache format or None for the bf16 MLACache, layout, int8-dot flag, faults).
DEEPSEEK_CHECKS = {"Moonlight int8 seq latent": ("int8", "seq", False, DEEPSEEK_FAULTS),
                   "Moonlight fp4 seq latent": ("float4_e2m1", "seq", False, ()),
                   "Moonlight bf16 MLACache": (None, "seq", False, ()),
                   "Moonlight int8 d-major int8dot": ("int8", "dmajor", True, DEEPSEEK_FAULTS_DMAJOR)}


@contextlib.contextmanager
def deepseek_fault(name):
    """A wrong B13, B7, K2 plane mode, per-row quantize kernel, router or
    MoE, on the kernel path only (under ``plain_path()`` the original runs)."""
    import dataclasses

    from torchmx_tpu_torch.models import deepseek
    from torchmx_tpu_torch.models.mixtral import MixtralSparseMoeBlock
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops import cuda_mla
    from torchmx_tpu_torch.ops.backend import on_cuda

    if name.startswith("B13"):
        mod, attr = cuda_mla, "mx_mla_attention"
        orig = cuda_mla.mx_mla_attention

        def faulty(ql, qr, ld, ls, rd, rs, q_off, kv_len, sm, elem, n, v_from_rot=False, drop_last_chunk=False):
            if on_cuda(ql):
                if "scale" in name:
                    ls, rs = ls.roll(-1, dims=1).contiguous(), rs.roll(-1, dims=1).contiguous()
                elif "rope" in name:
                    v_from_rot = True
                else:
                    drop_last_chunk = True
            return orig(ql, qr, ld, ls, rd, rs, q_off, kv_len, sm, elem, n, v_from_rot=v_from_rot,
                        drop_last_chunk=drop_last_chunk)
    elif name.startswith("mx_quantize_rows"):
        mod, attr = deepseek, "mx_quantize_rows"
        orig = deepseek.mx_quantize_rows

        def faulty(x1, x2, elem, sm_scale=1.0, out=None, pos=None):
            if on_cuda(x1) and out is not None:
                pos = pos + 1  # the kernel clamps the start to L - s
            return orig(x1, x2, elem, sm_scale, out, pos)
    elif name.startswith("B7"):
        mod, attr = kf, "mx_matmul_fp4_pair"
        orig = kf.mx_matmul_fp4_pair

        def faulty(x, w, sw, act_fq=None):
            if on_cuda(x):
                if "nibbles" in name:
                    w = ((w & 0xF) << 4) | (w >> 4)
                else:
                    sw = sw[0::2].repeat_interleave(2, dim=0)[:sw.shape[0]].contiguous()
            return orig(x, w, sw, act_fq)
    elif name.startswith("K2 writes"):
        mod, attr = kf, "mx_fake_quantize_planes"
        orig = kf.mx_fake_quantize_planes

        def faulty(x, act_fq=None):
            out = orig(x, act_fq)
            if on_cuda(x):
                half = out.shape[1] // 2
                out = torch.cat([out[:, half:], out[:, :half]], dim=1).contiguous()
            return out
    elif name.startswith("the shared"):
        mod, attr = deepseek.DeepseekV3MoE, "forward"
        orig = deepseek.DeepseekV3MoE.forward

        def faulty(self, x):
            return MixtralSparseMoeBlock.forward(self, x) if on_cuda(x) else orig(self, x)
    else:
        mod, attr = deepseek, "route_noaux_tc"
        orig = deepseek.route_noaux_tc

        def faulty(scores, bias, config):
            if not on_cuda(scores):
                return orig(scores, bias, config)
            if name.startswith("routed"):
                return orig(scores, bias, dataclasses.replace(config, routed_scaling_factor=1.0))
            k = config.num_experts_per_tok
            if name.startswith("the correction"):  # chosen on the raw scores, weighted by the biased ones
                top_idx = torch.sort(deepseek.noaux_choice(scores, torch.zeros_like(bias), config), dim=-1,
                                     descending=True, stable=True)[1][:, :k]
                top_w = (scores + bias[None, :]).gather(1, top_idx)
                top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
                return top_w * config.routed_scaling_factor, top_idx.to(torch.int32)
            # The first token whose k-th and (k+1)-th choices lie more than
            # 5e-2 apart takes its (k+1)-th expert in place of its k-th.
            top_w, top_idx = orig(scores, bias, config)
            vals, idx = torch.sort(deepseek.noaux_choice(scores, bias, config), dim=-1, descending=True, stable=True)
            wide = torch.nonzero(vals[:, k - 1] - vals[:, k] > 5e-2)
            if wide.numel():
                t = int(wide[0, 0])
                top_idx = top_idx.clone()
                top_idx[t, k - 1] = idx[t, k].to(torch.int32)
            return top_w, top_idx
    setattr(mod, attr, faulty)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def model_check_deepseek(dev, card, checks=tuple(DEEPSEEK_CHECKS), n_tokens: int = 12) -> dict:
    """Kernel path against plain path on a 2-layer model at Moonlight-16B-A3B
    width (layer 0 dense, layer 1 MoE with grouped experts; router rows 0 and
    1 tied), b=2, a 64-token prompt and ``n_tokens`` greedy tokens, with the
    routing tape (``NoauxRouteTape``): over the int8 seq latent (B13, with
    the ten planted faults of DEEPSEEK_FAULTS, each of which must fail a
    gate), the fp4 seq latent (B13-fp4), the bf16 ``MLACache`` (B13-bf16) and
    the int8 d-major latent with the all-int8 flag (B14 at decode, its query
    quantized in its prologue, JAX's eager route at prefill, the per-row
    quantize kernel at every latent write; one planted fault,
    DEEPSEEK_FAULTS_DMAJOR)."""
    model = build_moonlight(dev, card, 2, seed=1, tied_router=True)
    prompt = torch.randint(0, MOONLIGHT_16B["vocab_size"], (2, 64), generator=torch.Generator(dev).manual_seed(2),
                           device=dev)
    all_readings = {}
    for name in checks:
        elem, layout, int8dot, faults = DEEPSEEK_CHECKS[name]
        kv = None if elem is None else quant_configs(elem)[2]
        tie_gap = GATES[name]["tie_gap"]
        with kv_env(layout, int8dot):
            readings = {"sound": moe_readings(model, prompt, n_tokens, kv, True, tie_gap, NoauxRouteTape)}
            for fault in faults:
                with deepseek_fault(fault):
                    readings[fault] = moe_readings(model, prompt, n_tokens, kv, False, tie_gap, NoauxRouteTape)
        for fault, r in readings.items():
            log(f"model check {name} [{fault}]: 2 layers at Moonlight-16B-A3B width, b=2, {n_tokens} greedy tokens: "
                f"{json.dumps(r)} [{card}]")
        all_readings[name] = readings
    del model
    torch.cuda.empty_cache()
    apply_gates(all_readings, GATES, card)
    return all_readings


@contextlib.contextmanager
def no_plain_quantizer_on_the_card():
    """Within this block the plain quantizer raises on a CUDA tensor: the
    int8 d-major path's latent writes must go through the per-row quantize
    kernel (B14 quantizes its query in its prologue)."""
    from torchmx_tpu_torch import mx_array
    from torchmx_tpu_torch.ops import cuda_quantize

    orig = mx_array.quantize_mx_plain

    def guarded(data_hp, *a, **k):
        if data_hp.is_cuda:
            raise AssertionError(f"the plain quantizer ran on a CUDA tensor {tuple(data_hp.shape)}")
        return orig(data_hp, *a, **k)

    mx_array.quantize_mx_plain = cuda_quantize.quantize_mx_plain = guarded
    try:
        yield
    finally:
        mx_array.quantize_mx_plain = cuda_quantize.quantize_mx_plain = orig


def run_moonlight(dev, card, layers: int) -> tuple:
    """The Moonlight-16B-A3B main paths at full width and ``layers`` deep (27
    unless cut), MXFP4 weights (grouped experts on int8-domain codes), MXFP8
    activations, the f32 router: ``generate`` at b=1 and b=32 over the int8
    seq latent cache, the 48-request engine stream with all its checks, and
    ``generate`` at b=32 over the int8 d-major latent with the all-int8 flag
    (B14 at every decode step with its query quantized in its prologue, the
    per-row quantize kernel at every latent write, the plain quantizer raising
    on a CUDA tensor).
    Every decode step must launch each kernel as often as
    ``moonlight_launches_per_step`` says.  Returns (launches by
    path, launches per decode step by path, results)."""
    model = build_moonlight(dev, card, layers)
    paths, per_step, results = {}, {}, {"build_seconds": model.build_seconds}
    want = moonlight_launches_per_step(model.config)
    log(f"Moonlight: expected launches per decode step (from the model's structure): {json.dumps(want)}")
    paths["generate_moonlight"], res = run_slice(model, dev, card, "int8", weights="Moonlight fp4 grouped")
    for b, r in res.items():
        per_step[f"moonlight_b{b}"] = r["launches_per_decode_step"]
        results[f"generate_b{b}"] = r
        if r["launches_per_decode_step"] != want:
            raise AssertionError(f"Moonlight generate b={b}: a decode step launched {r['launches_per_decode_step']}, "
                                 f"expected {want}")
    results["engine"] = run_engine(model, dev, card, "int8", weights="moonlight")
    paths["engine_moonlight"] = results["engine"]["launches"]
    per_step["engine_moonlight"] = results["engine"]["launches_per_decode_step"]
    with kv_env(*CACHES["int8 d-major int8dot"][1:]), no_plain_quantizer_on_the_card():
        paths["generate_moonlight_int8dot"], res = run_slice(model, dev, card, "int8 d-major int8dot", batches=(32,),
                                                             weights="Moonlight fp4 grouped")
    want_b14 = moonlight_launches_per_step(model.config, int8dot=True)
    if res[32]["launches_per_decode_step"] != want_b14:
        raise AssertionError(f"Moonlight int8-dot generate: a decode step launched "
                             f"{res[32]['launches_per_decode_step']}, expected {want_b14}")
    results["generate_int8dot_b32"] = res[32]
    per_step["moonlight_int8dot_b32"] = res[32]["launches_per_decode_step"]
    del model
    torch.cuda.empty_cache()
    return paths, per_step, results


# -- this slice: Qwen2 (q/k/v biases, GQA groups of 7, head_dim 64) -------------------------------

# Qwen/Qwen2-7B config.json (the fields the port reads; use_sliding_window false), cut to
# QWEN2_LAYERS of its 28 layers in phase 10; Qwen/Qwen2-0.5B config.json at all 24 layers.
QWEN2_7B = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
                num_attention_heads=28, num_key_value_heads=4, rope_theta=1000000.0, rms_norm_eps=1e-6,
                max_position_embeddings=131072)
QWEN2_05B = dict(vocab_size=151936, hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
                 num_attention_heads=14, num_key_value_heads=2, rope_theta=1000000.0, rms_norm_eps=1e-6,
                 max_position_embeddings=131072, tie_word_embeddings=True)
QWEN2_LAYERS = 8
# Standard deviations of the seeded q/k/v biases: the k bias larger, as in the published
# checkpoints (Qwen2's k_proj biases reach tens where q's and v's stay near 1).
QWEN2_BIAS_STD = {"q_proj": 0.3, "k_proj": 2.0, "v_proj": 0.3}
QWEN2_GROUPS = (3, 5, 6, 7)  # the groups K5 and K7 run in the kernel built for 4 or 8 rows
QWEN2_WIDTHS = (896, 3584)  # Qwen2-0.5B's and Qwen2-7B's norm widths
QWEN2_ADMISSION = ("whole b=1 L=1024 sq=384", 1, 1024, 384, [384])  # an engine admission at a group of 7
# Phase 10's generate calls (prompt 64, 128 new tokens: a cache of 256 positions, one tile of 256, one
# K4 / K6 share, one K7 tile): label, b, L, sq, kv_len of each row.  The b=32 decode holds every step's
# kv_len (65 .. 192) in its rows.
QWEN2_GENERATE_CASES = [("decode b=32 L=256 kv_len 65..192", 32, 256, 1, MLA_GK_KV),
                        ("decode b=1 L=256 kv_len 192", 1, 256, 1, [192]),
                        ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32)]


def build_qwen2(dev, card, cfg: dict, layers: int, seed: int = 0, weights="float4_e2m1", acts="float8_e4m3"):
    """A Qwen2 at full width, ``layers`` deep: seeded random bf16 weights and
    q/k/v biases (``QWEN2_BIAS_STD``) made on the card and quantized layer by
    layer."""
    from torchmx_tpu_torch.models.qwen2 import Qwen2Config, Qwen2ForCausalLM
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.quant_api import build_quantized

    qa, qm, _ = quant_configs(weights=weights, acts=acts)
    config = Qwen2Config(**{**cfg, "num_hidden_layers": layers})
    gen = torch.Generator(dev).manual_seed(seed + 1000)

    def biases(layer):
        with torch.no_grad():
            for name, std in QWEN2_BIAS_STD.items():
                bias = getattr(layer.self_attn, name).bias
                bias.copy_(torch.randn(bias.shape, generator=gen, device=dev) * std)

    cuda_lib.reset_launch_counts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_quantized(Qwen2ForCausalLM, config, qa, qm, dev, torch.Generator(dev).manual_seed(seed), biases)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    name = "Qwen2-0.5B" if cfg is QWEN2_05B else "Qwen2-7B"
    layouts = sorted({(m.weight.elem_dtype.name, m.weight.fp4_pack) for m in model.modules() if hasattr(m, "qconfig")
                      and hasattr(m, "weight")})
    log(f"model: built and quantized {name} ({layers} of {cfg['num_hidden_layers']} layers), {weights} weights / "
        f"{acts} activations (layouts {layouts}), q/k/v biases of std {json.dumps(QWEN2_BIAS_STD)}, in "
        f"{seconds:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card [{card}]")
    model.build_seconds = seconds
    return model


def _qwen2_timed(row: dict, fn, plain, args, seq, timer) -> dict:
    """``row`` with the kernel's, its plain version's and SDPA's times on
    ``args`` (K4's arguments ``seq`` for SDPA) and the bound."""
    import torch.nn.functional as F

    k, v, mask = _sdpa_inputs(seq)
    t_b, by = bound(*_attn_work(seq))
    row.update(ms=timer(lambda: fn(*args)), plain_ms=timer(lambda: plain(*args), reps=5),
               library_ms=timer(lambda: F.scaled_dot_product_attention(
                   seq[0], k, v, attn_mask=mask, scale=seq[7], enable_gqa=True)),
               bound_ms=t_b, bound_by=by)
    return row


def _qwen2_k57(name, seq, G, label, timer, fault: bool, timed: bool) -> dict:
    """K5 (over ``seq``, an int8 seq cache) or K7 (the same cache d-major)
    against its plain version under its gates (K5: abs, worst row and whole
    output; K7: abs and worst row), finite, 0 for a row that sees no key,
    the same bytes on a second launch; with ``fault``, its query heads read
    at the padded instance's stride must fail the gate."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    k5 = name.endswith("chunkdot")
    fn, plain = getattr(ca, name), getattr(ca, name + "_plain")
    args = seq[:8] if k5 else _to_dmajor(seq)[:8]
    empty = [i for i, n in enumerate(seq[6].tolist()) if n == 0]
    got = fn(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err, rel, l2, ok = k5_readings(got, ref)
    if not k5:
        ok = err <= 2e-2 and rel <= K7_ROW_REL
    hq, hkv = seq[0].shape[1], seq[1].shape[1]
    row = dict(G=G, case=label, hq=hq, hkv=hkv, max_abs_err=err, worst_row_rel=rel, rel_l2=l2)
    if fault:
        bad = fn(*args, pad_stride=True)
        row.update(zip(("fault_abs", "fault_row_rel", "fault_l2", "fault_passes"), k5_readings(bad, ref)))
        if not k5:
            row["fault_passes"] = row["fault_abs"] <= 2e-2 and row["fault_row_rel"] <= K7_ROW_REL
    log(f"{name} G={G} {label}: abs {err:.3e}, row / whole rel L2 {rel:.3e} / {l2:.3e}"
        + (f"; query heads at the padded stride: abs {row['fault_abs']:.3e}, row / whole "
           f"{row['fault_row_rel']:.3e} / {row['fault_l2']:.3e}" if fault else ""))
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} G={G} {label}: abs {err}, row / whole rel L2 {rel} / {l2}")
    if empty and got[empty].float().abs().max().item() != 0.0:
        raise AssertionError(f"{name} G={G} {label}: a row with no visible key must output 0")
    if not torch.equal(got, fn(*args)):
        raise AssertionError(f"{name} G={G} {label}: two launches on the same inputs differ")
    if row.get("fault_passes"):
        raise AssertionError(f"{name} G={G}: the query heads read at the padded stride pass the gate")
    if timed:
        _qwen2_timed(row, fn, plain, args, seq, timer)
        log(f"{name} G={G} timing", json.dumps(row))
    return row


def _qwen2_k46(seq, label, timer, out: dict) -> None:
    """K4 over ``seq`` and K6 over the same cache d-major at a group of 7,
    each against its plain version under its gates, K6 giving K4's bytes,
    timed; the rows go to ``out``."""
    from torchmx_tpu_torch.ops import cuda_attention as ca

    dm = _to_dmajor(seq)
    got4 = ca.mx_cached_attention(*seq)
    got6 = ca.mx_cached_attention_dmajor(*dm)
    torch.cuda.synchronize()
    for name, got, args, layout in (("mx_cached_attention", got4, seq, "seq"),
                                    ("mx_cached_attention_dmajor", got6, dm, "dmajor")):
        fn, plain = getattr(ca, name), getattr(ca, name + "_plain")
        err, rel, l2, ok = k46_readings(got, plain(*args), layout)
        log(f"{name} G=7 {label} ({seq[8]}): abs {err:.3e}, row / whole rel L2 {rel:.3e} / {l2:.3e}")
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} G=7 {label} ({seq[8]}): abs {err}, row / whole rel L2 {rel} / {l2}")
        row = _qwen2_timed(dict(G=7, case=f"{label} {seq[8]}", hq=28, hkv=4, max_abs_err=err, worst_row_rel=rel,
                                rel_l2=l2), fn, plain, args, seq, timer)
        log(f"{name} G=7 timing", json.dumps(row))
        out[name].append(row)
    check_k6_against_k4(got6, got4, f"G=7 {label} ({seq[8]})")


def check_qwen2_attention(dev, timer, gen) -> dict:
    """K5 and K7 at the GQA groups that run padded (3, 5, 6, 7: hq = 4 G over
    4 KV heads, 28 over 4 is Qwen2-7B's decode) over K7's decode cases
    (``K7_CASES``: b=32 L=1024 ragged, b=1 kv 700, b=4 L=8192) against their
    plain versions (``_qwen2_k57``); each kernel's planted fault (its query
    heads read at the padded instance's stride) must fail its gate at every
    padded group.  At a group of 7 and of 8 (hq 32 over the same 4 KV heads:
    the same cache bytes) each case is timed with the plain version and SDPA
    beside it.  K4 and K6 at a group of 7 at the same decode cases and a
    whole admission of 384 tokens (``_qwen2_k46``).  Then every attention
    kernel at phase 10's ``generate`` shapes (``QWEN2_GENERATE_CASES``): K4
    and K6 over the fp8 cache, K6 (and K4) over the int8 cache at the
    prefill, K5 and K7 over the int8 caches at the decode steps, all timed.
    Returns {kernel: readings}."""
    out = {"mx_cached_attention_chunkdot": [], "mx_cached_attention_int8dot": [], "mx_cached_attention": [],
           "mx_cached_attention_dmajor": []}
    for G in QWEN2_GROUPS + (8,):
        for label, b, L, kv in K7_CASES:
            seq = _attn_case(dev, gen, b, 4 * G, 4, 128, L, 1, kv, "int8", never_written=True)
            for name in ("mx_cached_attention_chunkdot", "mx_cached_attention_int8dot"):
                out[name].append(_qwen2_k57(name, seq, G, label, timer, fault=G in QWEN2_GROUPS and
                                            label.startswith("decode b=32"), timed=G in (7, 8)))
    # K4 and K6 at a group of 7: the decode cases over an fp8 cache (generate's) and a whole admission
    # over an int8 cache (the engine's).
    for label, b, L, sq, kv in [(lab, b, L, 1, kv) for lab, b, L, kv in K7_CASES] + [QWEN2_ADMISSION]:
        _qwen2_k46(_attn_case(dev, gen, b, 28, 4, 128, L, sq, kv, "float8_e4m3" if sq == 1 else "int8",
                              never_written=sq == 1), label, timer, out)
    for label, b, L, sq, kv in QWEN2_GENERATE_CASES:
        for elem in ("float8_e4m3", "int8"):
            seq = _attn_case(dev, gen, b, 28, 4, 128, L, sq, kv, elem, never_written=True)
            if elem == "float8_e4m3" or sq > 1:
                _qwen2_k46(seq, label, timer, out)
            else:
                for name in ("mx_cached_attention_chunkdot", "mx_cached_attention_int8dot"):
                    out[name].append(_qwen2_k57(name, seq, 7, label, timer, fault=False, timed=True))
    return out


def check_qwen2_norm(dev, timer, gen) -> list:
    """The RMSNorm kernel at Qwen2-0.5B's and Qwen2-7B's widths (896: 112
    threads of 8 elements, three and a half warps; 3584) at decode b=1, b=32
    and a b=32 prefill of 64: fused with K2 it is K2 of its own output bit for
    bit in all five formats (and over every bf16 pattern, as rows of the
    width); alone within one bf16 step of the plain version; every row the
    same bytes alone as among 37 rows.  Timed beside
    ``torch.nn.functional.rms_norm``.  Returns the rows."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_norm
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    rows = []
    for W in QWEN2_WIDTHS:
        w = (1 + 0.1 * torch.randn(W, generator=gen, device=dev)).to(torch.bfloat16)
        patterns = all_bf16_blocks(dev).reshape(-1)
        patterns = patterns[:patterns.numel() // W * W].reshape(-1, W)
        for label, x in [(f"({r}, {W})", torch.randn(r, W, generator=gen, device=dev).to(torch.bfloat16) * 4)
                         for r in (1, 32, 2048)] + [(f"all bf16 patterns {tuple(patterns.shape)}", patterns)]:
            for act in ("float8_e4m3", "int8", "float6_e3m2", "float6_e2m3", "float4_e2m1"):
                fused, want = cuda_norm.rms_norm(x, w, 1e-6, act), cq.mx_fake_quantize_kernel(
                    cuda_norm.rms_norm(x, w, 1e-6), act)
                nan = torch.isnan(fused.float()) & torch.isnan(want.float())
                bad = int(((fused.view(torch.int16) != want.view(torch.int16)) & ~nan).sum())
                if bad:
                    raise AssertionError(f"mx_rmsnorm fused with K2 {act} {label}: {bad} values differ")
        x = torch.randn(37, W, generator=gen, device=dev).to(torch.bfloat16) * 3
        whole = cuda_norm.rms_norm(x, w, 1e-6)
        for i in range(37):
            if not torch.equal(cuda_norm.rms_norm(x[i:i + 1], w, 1e-6), whole[i:i + 1]):
                raise AssertionError(f"mx_rmsnorm width {W}: row {i} alone differs from the row among 37")
        for r in (1, 32, 2048):
            x = torch.randn(r, W, generator=gen, device=dev).to(torch.bfloat16)
            got, ref = cuda_norm.rms_norm(x, w, 1e-6), cuda_norm.rms_norm_plain(x, w, 1e-6)
            steps = bf16_steps(got, ref)
            if steps > 1.0:
                raise AssertionError(f"mx_rmsnorm ({r}, {W}): {steps} bf16 steps from the plain version")
            n = x.numel()
            t_b, by = bound(2 * n + 2 * n + 2 * W, 3 * n)
            row = dict(shape=(r, W), bf16_steps=steps, values_differing=int((got != ref).sum()),
                       ms=timer(lambda: cuda_norm.rms_norm(x, w, 1e-6)),
                       fused_fp8_ms=timer(lambda: cuda_norm.rms_norm(x, w, 1e-6, "float8_e4m3")),
                       plain_ms=timer(lambda: cuda_norm.rms_norm_plain(x, w, 1e-6), reps=5),
                       library_ms=timer(lambda: F.rms_norm(x, (W,), w, 1e-6)), bound_ms=t_b, bound_by=by)
            log("mx_rmsnorm Qwen2 width timing", json.dumps(row))
            rows.append(row)
        log(f"mx_rmsnorm width {W}: fused = K2 of the norm bit for bit in five formats, every row the same "
            f"alone as among 37, within one bf16 step of the plain version")
    return rows


# Phase 3's Qwen2 checks: name -> (config, cache, planted faults).  The faults: the k bias dropped
# on the kernel path (it moves every K block's shared exponent before the cache write); K5 or K7
# reading its query heads at the stride of the 8-row instance a group of 7 runs in; and one fault of
# rounding's size a cache: K4 rounding p against the 64-position sub-tile maximum, K5 against its
# tile's own maximum, K7 rounding p's int8 codes down.
QWEN2_CHECKS = {"Qwen2-7B fp8 cache": (QWEN2_7B, "float8_e4m3", ("k bias dropped", "K4 p against the sub-tile maximum")),
                "Qwen2-7B int8 cache": (QWEN2_7B, "int8", ("k bias dropped", "K5 query heads at the padded stride",
                                                           "K5 p against its tile's own maximum")),
                "Qwen2-7B int8 d-major int8dot": (QWEN2_7B, "int8 d-major int8dot",
                                                  ("k bias dropped", "K7 query heads at the padded stride",
                                                   "K7 p codes rounded down")),
                "Qwen2-0.5B int8 cache": (QWEN2_05B, "int8", ("k bias dropped",))}
# The prompt of the Qwen2 checks: its 16 decode steps run over a cache of 384 positions, three of
# JAX's tiles of 128 (the rounding faults act across tiles and sub-tiles).
QWEN2_CHECK_PROMPT = 320
# Each attention fault of QWEN2_CHECKS: the wrapper and the planted-fault keyword it sets.
QWEN2_ATTENTION_FAULTS = {
    "K4 p against the sub-tile maximum": ("mx_cached_attention", "p_from_sub_tile_max"),
    "K5 query heads at the padded stride": ("mx_cached_attention_chunkdot", "pad_stride"),
    "K5 p against its tile's own maximum": ("mx_cached_attention_chunkdot", "p_from_own_tile_max"),
    "K7 query heads at the padded stride": ("mx_cached_attention_int8dot", "pad_stride"),
    "K7 p codes rounded down": ("mx_cached_attention_int8dot", "p_codes_down")}


@contextlib.contextmanager
def qwen2_fault(model, name):
    """A planted fault of QWEN2_CHECKS on the kernel path only (under
    plain_path() nothing changes)."""
    from torchmx_tpu_torch.ops import cuda_attention as ca
    from torchmx_tpu_torch.ops.backend import on_cuda

    if name == "k bias dropped":
        lins = [layer.self_attn.k_proj for layer in model.model.layers]
        for lin in lins:
            orig = lin._add_bias
            lin._add_bias = lambda out, _orig=orig: out if on_cuda(out) else _orig(out)
        try:
            yield
        finally:
            for lin in lins:
                del lin._add_bias
        return
    attr, kw = QWEN2_ATTENTION_FAULTS[name]
    orig = getattr(ca, attr)
    setattr(ca, attr, lambda q, *a, **k: orig(q, *a, **k, **{kw: on_cuda(q)}))
    try:
        yield
    finally:
        setattr(ca, attr, orig)


def model_check_qwen2(dev, card) -> dict:
    """Kernel path against plain path on 2-layer Qwen2 models with seeded
    nonzero q/k/v biases, b=2, a prompt of ``QWEN2_CHECK_PROMPT``, 16 greedy
    tokens (``model_readings``): at
    Qwen2-7B's width (a GQA group of 7) over the fp8 seq cache (K4), the int8
    seq cache (K5 at every decode step) and the int8 d-major cache with the
    all-int8 flag (K7), and at Qwen2-0.5B's width (head_dim 64: JAX's eager
    route on both paths, counted, no attention kernel) over the int8 cache;
    each planted fault of QWEN2_CHECKS must fail a gate."""
    from torchmx_tpu_torch.ops import cuda_lib, fallbacks

    all_readings, models = {}, {}
    for name, (cfg, cache, faults) in QWEN2_CHECKS.items():
        if id(cfg) not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[id(cfg)] = build_qwen2(dev, card, cfg, 2, seed=1)
        model = models[id(cfg)]
        prompt = torch.randint(0, cfg["vocab_size"], (2, QWEN2_CHECK_PROMPT),
                               generator=torch.Generator(dev).manual_seed(2), device=dev)
        elem, layout, int8dot = CACHES[cache]
        kv, tie_gap = quant_configs(elem)[2], GATES[name]["tie_gap"]
        fallbacks.reset_fallback_counts()
        cuda_lib.reset_launch_counts()
        with kv_env(layout, int8dot):
            readings = {"sound": model_readings(model, prompt, 16, kv, True, tie_gap)}
            eager = sum(fallbacks.fallback_counts().values())
            launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            attention = {k: v for k, v in launches.items() if "attention" in k}
            for fault in faults:
                with qwen2_fault(model, fault):
                    readings[fault] = model_readings(model, prompt, 16, kv, False, tie_gap)
        readings["sound"].update(eager_route_calls=eager, launches=launches)
        if (cfg is QWEN2_05B) != (eager > 0) or (cfg is QWEN2_05B and (attention or not launches.get(
                "mx_matmul_fp4_pair"))):
            raise AssertionError(f"model check {name}: {eager} eager attention calls, launches {launches}: "
                                 f"head_dim 64 takes the eager route on both paths (B7 its linears), 128 never")
        for fault, r in readings.items():
            log(f"model check {name} [{fault}]: 2 layers, b=2, 16 greedy tokens: {json.dumps(r)} [{card}]")
        all_readings[name] = readings
    models.clear()
    fallbacks.reset_fallback_counts()
    apply_gates(all_readings, GATES, card)
    return all_readings


def qwen2_launches_per_step(layers: int, int8dot: bool = False) -> dict:
    """Qwen2-7B's decode step: Llama's (``halves_launches_per_step``: its
    linears take K3's halves layout) with the decode attention kernel once a
    layer where the path has one (K7 with the all-int8 flag); the biases are
    plain adds."""
    want = halves_launches_per_step(layers)
    if int8dot:
        want["mx_cached_attention_int8dot"] = layers
    return want


def qwen05_launches_per_step(layers: int) -> dict:
    """Qwen2-0.5B's decode step: every linear K % 512 != 0, so B7 with its own
    K2 plane pass at each of a layer's 7 linears (no shared K2); K1 writes the
    cache once a layer; the RMSNorm kernel twice a layer and once at the end;
    no attention kernel (JAX's eager route) and no lm_head kernel (the tied
    embedding product)."""
    return {"mx_matmul_fp4_pair": 7 * layers, "mx_fake_quantize": 7 * layers, "mx_quantize": layers,
            "mx_rmsnorm": 2 * layers + 1}


def run_qwen2(dev, card, layers: int) -> tuple:
    """Phase 10.  Qwen2-7B at full width, ``layers`` deep: ``generate`` at b=1
    and b=32 over the fp8 seq cache (K4 at a group of 7), the 48-request
    engine stream over the int8 seq cache with every check of phase 5 (K5 at
    every decode step, K4 never), ``generate`` at b=32 over the int8 d-major
    cache with the all-int8 flag (K7 at every decode step).  Then Qwen2-0.5B
    at all 24 layers: ``generate`` at b=1 and b=32 over the int8 seq cache,
    B7 at every linear, no attention kernel, and JAX's eager route counted
    once a layer for the prefill and each of the 127 decode steps.  Returns
    (launches by path, launches per decode step by path, results)."""
    from torchmx_tpu_torch.ops import fallbacks

    paths, per_step, results = {}, {}, {}
    model = build_qwen2(dev, card, QWEN2_7B, layers)
    results["build_seconds_7b"] = model.build_seconds
    paths["generate_qwen2"], res = run_slice(model, dev, card, "float8_e4m3", weights="Qwen2-7B fp4",
                                             want=qwen2_launches_per_step(layers))
    for b, r in res.items():
        per_step[f"qwen2_b{b}"] = r["launches_per_decode_step"]
        results[f"generate_b{b}"] = r
    results["engine"] = run_engine(model, dev, card, "int8")
    paths["engine_qwen2"] = results["engine"]["launches"]
    per_step["engine_qwen2"] = results["engine"]["launches_per_decode_step"]
    with kv_env(*CACHES["int8 d-major int8dot"][1:]):
        paths["generate_qwen2_int8dot"], res = run_slice(model, dev, card, "int8 d-major int8dot", batches=(32,),
                                                         weights="Qwen2-7B fp4",
                                                         want=qwen2_launches_per_step(layers, int8dot=True))
    results["generate_int8dot_b32"] = res[32]
    per_step["qwen2_int8dot_b32"] = res[32]["launches_per_decode_step"]
    del model
    torch.cuda.empty_cache()
    if fallbacks.fallback_counts():
        raise AssertionError(f"the eager attention route ran off the head_dim-64 path: {fallbacks.fallback_counts()}")
    layers05 = QWEN2_05B["num_hidden_layers"]
    model = build_qwen2(dev, card, QWEN2_05B, layers05, weights="float4_e2m1")
    results["build_seconds_05b"] = model.build_seconds
    counted = {}
    with eager_route_calls_counted(counted, layers05):
        paths["generate_qwen05"], res = run_slice(model, dev, card, "int8", weights="Qwen2-0.5B fp4",
                                                  want=qwen05_launches_per_step(layers05))
    for b, r in res.items():
        per_step[f"qwen05_b{b}"] = r["launches_per_decode_step"]
        results[f"qwen05_generate_b{b}"] = r
        if any("attention" in k for k in r["launches"]):
            raise AssertionError(f"Qwen2-0.5B b={b}: an attention kernel launched: {r['launches']}")
    results["qwen05_eager_route_calls"] = counted
    del model
    torch.cuda.empty_cache()
    fallbacks.reset_fallback_counts()
    return paths, per_step, results


@contextlib.contextmanager
def eager_route_calls_counted(counted: dict, layers: int):
    """Around ``run_slice`` on Qwen2-0.5B: the eager attention route's count
    is set to 0 before each timed ``generate`` and must read ``layers`` x
    128 (a prefill and 127 decode steps) just after; ``counted`` receives
    the readings by batch."""
    from torchmx_tpu_torch.models import generate as gen_mod
    from torchmx_tpu_torch.ops import fallbacks

    orig = gen_mod.generate

    def counting(model, prompt, n, **kw):
        fallbacks.reset_fallback_counts()
        out = orig(model, prompt, n, **kw)
        calls = sum(v for k, v in fallbacks.fallback_counts().items() if k.startswith("cached_attention: "))
        if kw.get("return_logits"):  # the timed run (the warm-up asks for no logits)
            counted[f"b{prompt.shape[0]}"] = calls
            if calls != layers * n or set(fallbacks.fallback_counts()) - {
                    k for k in fallbacks.fallback_counts() if k.startswith("cached_attention: ")}:
                raise AssertionError(f"Qwen2-0.5B generate b={prompt.shape[0]}: the eager route counted "
                                     f"{fallbacks.fallback_counts()}, expected {layers} x {n} calls")
            log(f"Qwen2-0.5B generate b={prompt.shape[0]}: the eager attention route counted {calls} calls = "
                f"{layers} layers x {n} (prefill + {n - 1} decode steps): {json.dumps(fallbacks.fallback_counts())}")
        return out

    gen_mod.generate = counting
    try:
        yield
    finally:
        gen_mod.generate = orig


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=LLAMA_LAYERS,
                    help=f"depth of the Llama-3-8B models of phases 4-7 (default {LLAMA_LAYERS} of 32)")
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

    t_start = t0 = time.perf_counter()
    cuda_lib.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s into {cuda_lib.BUILD_DIR}")
    timer = Timer(dev)
    gen = torch.Generator(dev).manual_seed(1234)
    kernels = check_quantize_kernels(dev, timer, gen)
    k3, k3_rows = check_matmul_kernel(dev, timer, gen)
    format_entries, format_rows = check_format_kernels(dev, timer, gen)
    rmsnorm, rmsnorm_rows = check_rmsnorm_kernel(dev, timer, gen)
    b12, b12_rows = check_grouped_kernel(dev, timer, gen)
    router, router_rows = check_router_kernel(dev, timer, gen)
    k4, k4_rows = check_attention_kernel(dev, timer, gen)
    k5, int8_rows, k4_int8_err = check_int8_attention_kernels(dev, timer, gen)
    k4["max_abs_err"] = max(k4["max_abs_err"], k4_int8_err)
    k6, k7, dmajor_rows = check_dmajor_attention_kernels(dev, timer, gen)
    qwen2_rows = check_qwen2_attention(dev, timer, gen)
    for entry in (k4, k5, k6, k7):  # the Qwen2-7B decode (b=32 ragged) at a group of 7, and of 8 over the same bytes
        entry["qwen2"] = [r for r in qwen2_rows[entry["name"]] if r["G"] in (7, 8) and "ms" in r
                          and r["case"].startswith(("decode b=32", "whole"))]
    qwen2_rows["mx_rmsnorm"] = check_qwen2_norm(dev, timer, gen)
    k4_fp6_err, k4_fp6_rows = check_k4_fp6(dev, timer, gen)
    k4["max_abs_err"] = max(k4["max_abs_err"], k4_fp6_err)
    b13, b13_rows = check_mla_kernel(dev, timer, gen)
    b14, b14_rows = check_mla_int8dot_kernel(dev, timer, gen)
    rows_q, rows_q_rows = check_quantize_rows_kernel(dev, timer, gen)
    b7, b7_rows = check_fp4_pair_kernel(dev, timer, gen)
    router_f32_rows = check_router_f32(dev, timer, gen)
    router["f32_mode"] = next(r for r in router_f32_rows if r["T"] == 32 and r["shape"].startswith("Moonlight"))
    kernels += [k3, k4, k5, k6, k7, *format_entries, rmsnorm, b12, router, b7, b13, b14, rows_q]
    cache_write = check_cache_write(dev, timer, gen)
    row_invariance = check_row_invariance(dev)
    row_invariance["moe"] = check_moe_row_invariance(dev)
    row_invariance["slice6"] = check_slice6_row_invariance(dev)
    accuracy = attention_accuracy(dev, gen)
    log(f"phase 2 (kernels) done at {time.perf_counter() - t_start:.0f} s")
    check_readings = model_check(dev, card)
    check_readings.update(model_check_formats(dev, card))
    check_readings.update(model_check_mixtral(dev, card))
    check_readings.update(model_check_deepseek(dev, card))
    check_readings.update(model_check_qwen2(dev, card))
    log(f"phase 3 (model checks) done at {time.perf_counter() - t_start:.0f} s")
    model = build_model(dev, card, args.layers)
    # Each main path is driven with the counts set to 0 just before it and
    # read just after: generate() over the fp8 cache, the engine over the int8
    # cache, the engine over the int8 d-major cache with the all-int8 flag,
    # generate() over the fp4 d-major cache; then this slice's formats.
    paths, per_step = {}, {}
    paths["generate"], slice_results = run_slice(model, dev, card, want=halves_launches_per_step(args.layers))
    engine_results = run_engine(model, dev, card)
    paths["engine"] = engine_results["launches"]
    with kv_env(*CACHES["int8 d-major int8dot"][1:]):
        engine_dmajor = run_engine(model, dev, card, "int8 d-major int8dot")
    paths["engine_dmajor"] = engine_dmajor["launches"]
    with kv_env(*CACHES["float4_e2m1 d-major"][1:]):
        paths["generate_fp4_dmajor"], slice_fp4 = run_slice(model, dev, card, "float4_e2m1 d-major", batches=(32,),
                                                            want=halves_launches_per_step(args.layers))
    del model
    log(f"phases 4-6 (fp4 paths) done at {time.perf_counter() - t_start:.0f} s")
    format_paths, format_per_step, format_results = run_formats(dev, card, args.layers)
    paths.update(format_paths)
    log(f"phase 7 (the weight formats) done at {time.perf_counter() - t_start:.0f} s")
    mixtral_paths, mixtral_per_step, mixtral_results = run_mixtral(dev, card, MIXTRAL_LAYERS)
    paths.update(mixtral_paths)
    log(f"phase 8 (Mixtral-8x7B) done at {time.perf_counter() - t_start:.0f} s")
    moonlight_paths, moonlight_per_step, moonlight_results = run_moonlight(dev, card, MOONLIGHT_LAYERS)
    paths.update(moonlight_paths)
    log(f"phase 9 (Moonlight-16B-A3B) done at {time.perf_counter() - t_start:.0f} s")
    qwen2_paths, qwen2_per_step, qwen2_results = run_qwen2(dev, card, QWEN2_LAYERS)
    paths.update(qwen2_paths)
    log(f"phase 10 (Qwen2-7B, Qwen2-0.5B) done at {time.perf_counter() - t_start:.0f} s")
    plain_results = compare_with_plain_path(dev, card)
    plain_results_mixtral = compare_with_plain_path(dev, card, "mixtral")
    plain_results_deepseek = compare_with_plain_path(dev, card, "deepseek")
    for b, r in slice_results.items():
        per_step[f"b{b}"] = r["launches_per_decode_step"]
    per_step["engine"] = engine_results["launches_per_decode_step"]
    per_step["engine_dmajor"] = engine_dmajor["launches_per_decode_step"]
    per_step["generate_fp4_dmajor_b32"] = slice_fp4[32]["launches_per_decode_step"]
    per_step.update(format_per_step)
    per_step.update(mixtral_per_step)
    per_step.update(moonlight_per_step)
    per_step.update(qwen2_per_step)
    from torchmx_tpu_torch.ops import fallbacks
    if fallbacks.fallback_counts():
        raise AssertionError(f"the eager attention route ran off the head_dim-64 path: {fallbacks.fallback_counts()}")
    seq = {"mx_quantize", "mx_fake_quantize", "mx_matmul_fp4_halves", "mx_cached_attention", "mx_rmsnorm"}
    dmajor = (seq - {"mx_cached_attention"}) | {"mx_cached_attention_dmajor"}
    fmt = seq - {"mx_matmul_fp4_halves"}
    moe_path = {"mx_grouped_matmul", "mx_matmul_fp4_halves", "mx_cached_attention_chunkdot", "mx_quantize",
                "mx_fake_quantize", "mx_rmsnorm", "mx_router_logits"}
    on_path = {"generate": seq, "engine": seq | {"mx_cached_attention_chunkdot"},
               "engine_dmajor": dmajor | {"mx_cached_attention_int8dot"}, "generate_fp4_dmajor": dmajor,
               "engine_w8a8": fmt | {"mx_matmul_int8dot", "mx_matmul_1byte", "mx_cached_attention_chunkdot"},
               "generate_fp6": fmt | {"mx_matmul_fp6q"}, "generate_fp8": fmt | {"mx_matmul_fp8_halves"},
               "generate_fp8dot": fmt | {"mx_matmul_fp8dot", "mx_matmul_1byte"},
               "generate_mixtral": moe_path, "engine_mixtral": moe_path}
    moonlight = {"mx_mla_attention", "mx_matmul_fp4_halves", "mx_matmul_fp4_pair", "mx_grouped_matmul", "mx_quantize",
                 "mx_fake_quantize", "mx_rmsnorm", "mx_router_logits"}
    on_path.update(generate_moonlight=moonlight, engine_moonlight=moonlight,
                   generate_moonlight_int8dot=(moonlight - {"mx_mla_attention", "mx_quantize"})
                   | {"mx_mla_attention_int8dot", "mx_quantize_rows"})
    on_path.update(generate_qwen2=seq, engine_qwen2=seq | {"mx_cached_attention_chunkdot"},
                   generate_qwen2_int8dot=dmajor | {"mx_cached_attention_int8dot"},
                   generate_qwen05={"mx_matmul_fp4_pair", "mx_fake_quantize", "mx_quantize", "mx_rmsnorm"})
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0) for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["launches_per_decode_step"] = {path: counts.get(k["name"], 0) for path, counts in per_step.items()}
        for path, names in on_path.items():
            if k["name"] in names and k["launches_by_path"][path] <= 0:
                raise AssertionError(f"{k['name']} was never launched on the {path} path")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, matmul=k3_rows, matmul_formats=format_rows,
                       rmsnorm=rmsnorm_rows, attention=k4_rows, attention_int8=int8_rows,
                       attention_dmajor=dmajor_rows, cache_write=cache_write, row_invariance=row_invariance,
                       attention_accuracy=accuracy, model_check=check_readings,
                       slice=slice_results, engine=engine_results, engine_dmajor=engine_dmajor,
                       slice_fp4_dmajor=slice_fp4, formats=format_results, engine_vs_plain=plain_results,
                       grouped_matmul=b12_rows, router=router_rows, mixtral=mixtral_results,
                       engine_vs_plain_mixtral=plain_results_mixtral, attention_k4_fp6=k4_fp6_rows,
                       mla=b13_rows, mla_int8dot=b14_rows, quantize_rows=rows_q_rows, matmul_fp4_pair=b7_rows,
                       router_f32=router_f32_rows, qwen2_kernels=qwen2_rows, qwen2=qwen2_results,
                       moonlight=moonlight_results, engine_vs_plain_deepseek=plain_results_deepseek,
                       seconds=time.perf_counter() - t_start), f, indent=1)
    log("kernels: " + ", ".join(f"{k['name']} ok ({k['launches']} launches)" for k in kernels) + f" [{card}]")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
