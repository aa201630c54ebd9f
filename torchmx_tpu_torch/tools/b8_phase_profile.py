"""Where B8's (or K3's) mainloop spends its clock cycles, on the card.

Builds ``csrc/mx_matmul_fp6q.cu`` with ``-DB8_PHASE_PROFILE`` (with
``--kernel k3``: ``csrc/mx_matmul.cu`` with ``-DK3_PHASE_PROFILE``) into a
library of its own, runs the kernel on MXFP6 e3m2 weights (K3: MXFP4 and
MXFP8 halves) at the Llama-3-8B linears' shapes (each CTA walking its K
splits), and prints, for a thread of each warpgroup, the cycles per K stage
(128 K) of each mainloop phase, the instrumented kernel's time and the time
of the kernel as built for the main path (``chip_smoke.Timer``, at the
plan's own launch, its split reduce left out).

With ``--datapath-only`` it builds ``csrc/mx_matmul.cu`` with
``-DK3_DATAPATH_ONLY`` and ``csrc/mx_matmul_int8dot.cu`` with
``-DB9_DATAPATH_ONLY`` instead (the producer warp's TMA ring as built, the
consumers only waiting for each stage and releasing its slot) and times them
beside the kernels as built, at K3's gate/up and k/v shapes (fp4 and fp8
halves), B7's shared-expert down shape (fp4 pair, x in plane order) and B9's
gate/up, k/v and down shapes (int8, x in K1's dot order): the time of the
weight and x stream alone against the whole mainloop's, and the bytes'
bound.  With ``--datapath-only-b12`` the same for B12
(``csrc/mx_grouped_matmul.cu`` with ``-DB12_DATAPATH_ONLY``) at the MoE
shapes of ``chip_smoke.B12_SHAPES``, int8 experts, tm 128, each expert's rows
bounded by the token count (the arguments are token counts).  Run from the
repository root on a machine with one card:

    python3 torchmx_tpu_torch/tools/b8_phase_profile.py [--kernel b8|k3] [M ...]
    python3 torchmx_tpu_torch/tools/b8_phase_profile.py --datapath-only [M ...]
    python3 torchmx_tpu_torch/tools/b8_phase_profile.py --datapath-only-b12 [T ...]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

from torchmx_tpu_torch.mx_array import MXTensor  # noqa: E402
from torchmx_tpu_torch.ops import cuda_lib  # noqa: E402
from torchmx_tpu_torch.ops import cuda_matmul as cm  # noqa: E402
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf  # noqa: E402
from torchmx_tpu_torch.ops import cuda_quantize as cq  # noqa: E402

SHAPES = {"gate_proj/up_proj": (4096, 14336), "down_proj": (14336, 4096), "q_proj/o_proj": (4096, 4096)}
# Per kernel: the source, the profile flag, the decode phase's name, and for
# each element format its weight layout, launch function and plan.
KERNELS = {
    "b8": ("mx_matmul_fp6q", "-DB8_PHASE_PROFILE", "rebuild + decode",
           {"float6_e3m2": (lambda t: t.to_fp6_quarters(), "mx_matmul_fp6q_launch", kf.plan_fp6q)}),
    "k3": ("mx_matmul", "-DK3_PHASE_PROFILE", "decode",
           {"float4_e2m1": (lambda t: t.to_fp4_halves(), "mx_matmul_fp4_halves_launch", cm.plan_halves),
            "float8_e4m3": (lambda t: t.to_fp8_halves(), "mx_matmul_fp8_halves_launch", cm.plan_halves)}),
}


def main(kernel: str, ms) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("b8_phase_profile: no CUDA device")
    dev = torch.device("cuda")
    src, flag, decode_name, formats = KERNELS[kernel]
    phases = ("wgmma start", "wgmma wait", decode_name, "stage wait", "fetch", "split add + rest")
    profiled = cuda_lib.build_variant(src, flag)
    timer, gen = chip_smoke.Timer(dev), torch.Generator(dev).manual_seed(0)
    print(chip_smoke.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (K, N) in SHAPES.items():
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        for elem, (layout, fn, plan_of) in formats.items():
            q = layout(MXTensor.to_mx(w, elem).T)
            for M in ms:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                plan = plan_of(M, N, K, sms) if kernel == "b8" else plan_of(M, N, K, sms, elem)
                # B8's launch takes the element code; K3's function names its format.
                elem_arg = (cuda_lib.ELEM_CODES[elem],) if kernel == "b8" else ()

                def launch(lib, ws, walk):
                    rc = getattr(lib, fn)(x.data_ptr(), q.data.data_ptr(), q.scale_e8m0.data_ptr(), out.data_ptr(),
                                          ws.data_ptr(), M, N, K, *elem_arg, plan.splits, walk,
                                          torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                counters = torch.zeros(16, dtype=torch.int64, device=dev)
                launch(profiled, counters, 1)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                launch(profiled, counters, 1)
                end.record()
                torch.cuda.synchronize()
                ms_ = start.elapsed_time(end)
                counters.zero_()
                launch(profiled, counters, 1)
                v = counters.tolist()
                for who, o in (("warpgroup 0", 0), ("warpgroup 1", 8)):
                    stages = max(v[o + 7], 1)
                    parts = ", ".join(f"{name} {v[o + i] / stages:.0f}" for i, name in enumerate(phases))
                    print(f"{label} {elem} M={M} N={N} K={K}: {ms_:.4f} ms (instrumented); {who}: "
                          f"{v[o + 6] / stages:.0f} cycles per K stage: {parts}", flush=True)
                ws = torch.empty((plan.splits, M, N) if plan.splits > 1 and not plan.walk else (1,),
                                 dtype=torch.float32, device=dev)
                kernel_ms = timer(lambda: launch(cuda_lib.lib(src), ws, int(plan.walk)))
                print(f"{label} {elem} M={M}: the kernel {kernel_ms:.4f} ms ({plan.splits} splits, walk {plan.walk})",
                      flush=True)


# The data-path-only comparison: label -> (element format, layout, K, N).
DATAPATH_SHAPES = {"K3 gate/up": ("float4_e2m1", "halves", 4096, 14336),
                   "K3 k/v": ("float4_e2m1", "halves", 4096, 1024),
                   "K3-fp8 gate/up": ("float8_e4m3", "halves", 4096, 14336),
                   "B7 shared down_proj": ("float4_e2m1", "pair", 2816, 2048),
                   "B9 gate/up": ("int8", "int8dot", 4096, 14336),
                   "B9 k/v": ("int8", "int8dot", 4096, 1024),
                   "B9 down": ("int8", "int8dot", 14336, 4096)}


def datapath_only(ms) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("b8_phase_profile: no CUDA device")
    dev = torch.device("cuda")
    variants = {"mx_matmul": cuda_lib.build_variant("mx_matmul", "-DK3_DATAPATH_ONLY"),
                "mx_matmul_int8dot": cuda_lib.build_variant("mx_matmul_int8dot", "-DB9_DATAPATH_ONLY")}
    timer, gen = chip_smoke.Timer(dev), torch.Generator(dev).manual_seed(0)
    print(chip_smoke.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (elem, layout, K, N) in DATAPATH_SHAPES.items():
        w = MXTensor.to_mx((torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16), elem).T
        if layout == "halves":
            w = w.to_fp4_halves() if elem == "float4_e2m1" else w.to_fp8_halves()
        src = "mx_matmul_int8dot" if layout == "int8dot" else "mx_matmul"
        fn = {"halves": f"mx_matmul_{'fp4' if elem == 'float4_e2m1' else 'fp8'}_halves_launch",
              "pair": "mx_matmul_fp4_pair_launch", "int8dot": "mx_matmul_int8dot_launch"}[layout]
        w_bytes = K * N / 32 + K * N / (2 if elem == "float4_e2m1" else 1)
        for M in ms:
            if layout == "int8dot" and M > kf.INT8DOT_MAX_M:  # B9 takes M <= 256
                continue
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            if layout == "int8dot":
                plan = kf.plan_int8dot(M, N, K, sms)
                px_t, x = cq.mx_quantize_dot(x, "int8")  # the kernel reads x's codes and f32 scale factors
                x_args, x_bytes = (x.data_ptr(), px_t.data_ptr()), x.numel() + 4 * px_t.numel()
                tail, post = (px_t.shape[1],), (0,)  # Mp; reduce: the main kernel alone
            else:
                plan = kf.plan_pair(M, N, K, sms) if layout == "pair" else cm.plan_halves(M, N, K, sms, elem)
                if layout == "pair":
                    x = cq.mx_fake_quantize_planes(x)
                x_args, x_bytes, tail, post = (x.data_ptr(),), 2 * x.numel(), (), ()
            out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            ws = torch.empty((plan.splits, M, N) if plan.splits > 1 and not plan.walk else (1,),
                             dtype=torch.float32, device=dev)

            def launch(lib):
                rc = getattr(lib, fn)(*x_args, w.data.data_ptr(), w.scale_e8m0.data_ptr(), out.data_ptr(),
                                      ws.data_ptr(), M, N, K, *tail, plan.splits, int(plan.walk), *post,
                                      torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            full, stream = timer(lambda: launch(cuda_lib.lib(src))), timer(lambda: launch(variants[src]))
            bytes_ms = chip_smoke.bound(w_bytes + x_bytes + 2 * M * N)[0]
            print(f"{label} {elem} {layout} M={M} N={N} K={K} ({plan.splits} splits, walk {plan.walk}): "
                  f"the kernel {full:.4f} ms, its data path alone {stream:.4f} ms ({stream / full:.0%}), "
                  f"bytes' bound {bytes_ms:.4f} ms", flush=True)


def datapath_only_b12(ts) -> None:
    from torchmx_tpu_torch.mx_array import quantize_stacked
    from torchmx_tpu_torch.ops import cuda_moe, moe

    if not torch.cuda.is_available():
        raise SystemExit("b8_phase_profile: no CUDA device")
    dev = torch.device("cuda")
    variant = cuda_lib.build_variant("mx_grouped_matmul", "-DB12_DATAPATH_ONLY")
    timer, gen = chip_smoke.Timer(dev), torch.Generator(dev).manual_seed(0)
    print(chip_smoke.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tm = chip_smoke.GROUPED_TM
    for label, (E, k, K, N) in chip_smoke.B12_SHAPES.items():
        w, s = quantize_stacked((torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16),
                                "int8")
        for T in ts:
            x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
            xs, te, tr, _ = moe.group_tokens(x, chip_smoke._routing(dev, gen, T, False, E, k), tm, E)
            bounds = moe.row_bounds(T, k, E)
            plan = cuda_moe.plan_grouped(xs.shape[0], N, K, tm, sms, **bounds)
            out = torch.empty(xs.shape[0], N, dtype=torch.bfloat16, device=dev)
            ws = torch.empty(plan.ws_shape or (1,), dtype=torch.float32, device=dev)
            live = len({e for e, n in zip(te.tolist(), tr.tolist()) if n})

            def launch(lib):
                rc = lib.mx_grouped_matmul_launch(xs.data_ptr(), w.data_ptr(), s.data_ptr(), te.data_ptr(),
                                                  tr.data_ptr(), out.data_ptr(), ws.data_ptr(), xs.shape[0], N, K,
                                                  E, tm, cuda_lib.ELEM_CODES["int8"], plan.ext, plan.nb, plan.splits,
                                                  int(plan.walk), 0, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            full = timer(lambda: launch(cuda_lib.lib("mx_grouped_matmul")))
            stream = timer(lambda: launch(variant))
            bytes_ms = chip_smoke._b12_bound(T, K, N, live, "int8", k)[0]
            print(f"B12 {label} T={T} ({live} live experts, nb {plan.nb}, {plan.splits} splits, walk {plan.walk}): "
                  f"the kernel {full:.4f} ms, its data path alone {stream:.4f} ms ({stream / full:.0%}), "
                  f"bound {bytes_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="b8")
    ap.add_argument("--datapath-only", action="store_true",
                    help="time K3's, B7's and B9's mainloop with consumers that only wait and release "
                         "(K3_DATAPATH_ONLY, B9_DATAPATH_ONLY)")
    ap.add_argument("--datapath-only-b12", action="store_true",
                    help="the same for B12 (B12_DATAPATH_ONLY); the arguments are token counts")
    ap.add_argument("ms", type=int, nargs="*", default=None)
    args = ap.parse_args()
    if args.datapath_only_b12:
        datapath_only_b12(args.ms or [1, 32, 512, 2048])
    elif args.datapath_only:
        datapath_only(args.ms or [32, 2048])
    else:
        main(args.kernel, args.ms or [2048])
