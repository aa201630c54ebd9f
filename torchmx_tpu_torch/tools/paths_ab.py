"""One kernel's served paths, measured by one checkout's own ``chip_smoke.py``,
for an A/B of two versions of the kernel on one card.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/paths_ab.py --kernel NAME[,NAME...] --paths f,d,... [--root DIR] [--label NAME] [--layers N]

``--kernel`` names the kernel as ``chip_smoke.device_time_by_kernel`` does
(several names are summed, e.g. B12 and its split reduce).  ``--root``
imports ``chip_smoke`` and ``torchmx_tpu_torch`` from another checkout (for
instance a parent commit unpacked by ``git archive HEAD chip_smoke.py
torchmx_tpu_torch | tar -x -C _chip_copies/parent``), so that two versions run
the same phases on one card in one call; run them in turns (parent, change,
change, parent).  ``--layers`` cuts every model's depth (default: Llama-3-8B
32, Mixtral-8x7B 32, Moonlight-16B-A3B 27, Qwen2-7B 28).

Paths (``chip_smoke``'s models, seeded random weights; g, f, d, e, w and pd
at Llama-3-8B width):

* ``g``: ``generate`` b=32, MXFP4 weights, the fp8 seq cache (K3, K4);
* ``e``: the engine stream, MXFP4 weights over the int8 seq cache (K5 at
  every decode step, K4 at admissions), with every check of ``run_engine``;
  besides, a torch.profiler window over the admission of 32 requests (K4's
  device ms an admission), and the same admissions' wall time on the host
  clock without the profiler;
* ``f``: ``generate`` b=32 over the fp4 d-major cache (K6 at prefill and at
  every decode step);
* ``d``: the engine stream over the int8 d-major cache with
  ``TORCHMX_ATTN_INT8_DOT=1`` (K7 at every decode step, K6 at admissions),
  with every check of ``run_engine``; besides, a torch.profiler window over
  the admission of 32 requests (the kernel's device ms an admission) and
  their wall time on the host clock without the profiler;
* ``w``: the W8A8 engine stream over the int8 seq cache (B9);
* ``pd``: ``generate`` b=32, MXFP8 weights under ``TORCHMX_FP8_DOT=1``, the
  fp8 cache (B9-fp8);
* ``gm``: Mixtral ``generate`` b=32 (B12, int8 seq cache);
* ``gk`` / ``ek``: Moonlight ``generate`` b=32 / the engine stream over the
  int8 seq latent (B13);
* ``gkd``: Moonlight ``generate`` b=32 over the int8 d-major latent with
  ``TORCHMX_ATTN_INT8_DOT=1`` (B14);
* ``q``: the Qwen2-7B engine stream (seeded q/k/v biases) over the int8 seq
  cache (K5 at a GQA group of 7 at every decode step, K4 at admissions),
  with every check of ``run_engine``;
* ``qd``: Qwen2-7B ``generate`` b=32 over the int8 d-major cache with
  ``TORCHMX_ATTN_INT8_DOT=1`` (K7 at a group of 7 at every decode step, K6
  at prefill);
* ``host``: the wrapper's host us a call, 200 calls queued without a
  synchronisation (host clock): K5 at E's decode shape (b=32, L=1024,
  kv_len 0 .. 1024 as a tensor, as the engine passes it), K6 at F's decode shape (b=32, L=256, kv_len
  192, numbers as ``generate`` passes them), B13 at EK's (b=32, L=1024,
  kv_len 1 .. 1024), K7 at D's (b=32, L=1024, kv_len 0 .. 1024 as a tensor,
  as the engine passes it; q's quantization inside the call), B14 at GKD's
  (b=32, L=256, kv_len 192, numbers as ``generate`` passes them; q's
  quantization inside the call, a launch of its own in the parent).

Each path reports tok/s, the kernel's device ms a decode step, its launches'
durations in that window (mean, median, p10, p90, max, and the mean of
those that start after the device idled more than 10 us against those
that start at once; us), the device's busy ms a step and idle share (the torch.profiler window of 8 decode steps
that ``run_slice`` and ``run_engine`` take), the launches of a decode step,
the peak device memory (``max_memory_allocated`` over the run, the weights
included) and the bytes the split-KV kernels' combine buffers hold after it.
Writes ``chiprun_out/paths_ab_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

LLAMA_PATHS, MOONLIGHT_PATHS, QWEN2_PATHS = ("g", "f", "d", "e", "w", "pd"), ("gk", "ek", "gkd"), ("q", "qd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, help="the kernel's name(s) in the device-time breakdown, comma-separated")
    ap.add_argument("--paths", required=True, help="comma-separated: " + ",".join(
        LLAMA_PATHS + ("gm",) + MOONLIGHT_PATHS + QWEN2_PATHS + ("host",)))
    ap.add_argument("--root", default=".", help="checkout to import chip_smoke and the package from")
    ap.add_argument("--label", default="change")
    ap.add_argument("--layers", type=int, default=None, help="every model's depth (default: its own)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("paths_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_lib

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not from {root}")
    dev, card = torch.device("cuda"), cs.card_line()
    cuda_lib.build_all()
    names, paths = args.kernel.split(","), args.paths.split(",")
    out = dict(label=args.label, root=root, card=card, kernel=names)

    def scratch_bytes():  # the split-KV combine buffers on every device
        try:
            from torchmx_tpu_torch.ops import split_kv
        except ImportError:  # a checkout from before the shared buffers: B13's own
            from torchmx_tpu_torch.ops import cuda_mla

            return sum(t.numel() * t.element_size() for pair in getattr(cuda_mla, "_B13_SCRATCH", {}).values()
                       for t in pair)
        return split_kv.held_bytes()

    launch_us: dict = {}  # the named kernels' launches in the last profile window

    def spy(prof, by_kernel=cs.device_time_by_kernel):
        """chip_smoke.device_time_by_kernel, and the named kernels' launch
        durations, each with the device's idle gap before it (us)."""
        evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        durs, gaps, end = [], [], float("-inf")
        for t0, t1, n in evs:
            if next((k for sub, k in cs.KERNEL_OF_DEVICE_NAME if sub in n), "pytorch") in names:
                durs.append(t1 - t0)
                gaps.append(t0 - end)
            end = max(end, t1)
        launch_us.clear()
        if durs:
            order = sorted(durs)
            after = [d for d, g in zip(durs, gaps) if g > 10]
            busy = [d for d, g in zip(durs, gaps) if g <= 10]
            launch_us.update(n=len(durs), mean=sum(durs) / len(durs), median=order[len(order) // 2],
                             p10=order[len(order) // 10], p90=order[9 * len(order) // 10], max=order[-1],
                             after_idle_n=len(after), after_idle_mean=sum(after) / len(after) if after else None,
                             back_to_back_mean=sum(busy) / len(busy) if busy else None)
        return by_kernel(prof)

    cs.device_time_by_kernel = spy

    def record(name, r, dev_ms, layers):
        timed = isinstance(dev_ms, dict)
        kernel_ms = sum(dev_ms.get(k, 0.0) for k in names) if timed else None
        out[name] = dict(layers=layers, tokens_per_s=r["tokens_per_s"], kernel_device_ms_per_step=kernel_ms,
                         busy_ms_per_step=dev_ms.get("busy") if timed else None,
                         device_idle_share=r.get("device_idle_share"), peak_gib=r["peak_gib"],
                         scratch_bytes=scratch_bytes(), launches_per_decode_step=r["launches_per_decode_step"],
                         device_ms_per_step=dev_ms, kernel_launch_us=dict(launch_us))
        print(f"[{args.label}] {name} at {layers} layers: {r['tokens_per_s']:.1f} tok/s, {args.kernel} {kernel_ms} "
              f"device ms a step, busy {out[name]['busy_ms_per_step']}, idle {r.get('device_idle_share')}, peak "
              f"{r['peak_gib']:.3f} GiB, combine buffers {out[name]['scratch_bytes']} bytes; a launch (us): "
              f"{json.dumps({k: round(v, 2) if isinstance(v, float) else v for k, v in launch_us.items()})} "
              f"[{card}]", flush=True)

    def slice_path(name, model, cache, weights, layers, want=None):
        _, res = cs.run_slice(model, dev, card, cache, batches=(32,), weights=weights, want=want)
        record(name, res[32], res[32].get("device_ms_per_decode_step"), layers)

    def engine_path(name, model, cache, weights, layers):
        r = cs.run_engine(model, dev, card, cache, weights=weights)
        record(name, r, r.get("device_ms_per_step"), layers)

    def admissions(name, model, cache):  # the kernel's device ms over the admission of 32 requests
        from torchmx_tpu_torch.models.serve import DecodeEngine

        kv = cs.quant_configs(cs.CACHES[cache][0])[2]
        prefix, requests = cs.make_requests(model.config.vocab_size, seed=7)
        eng = DecodeEngine(model, cs.ENGINE_BATCH, cs.ENGINE_LEN, kv_cache_config=kv)
        eng.cache_prefix(prefix)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # host clock, no profiler: the admissions' wall time
        for r in requests[:cs.ENGINE_BATCH]:
            eng.add(r["prompt"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        eng = DecodeEngine(model, cs.ENGINE_BATCH, cs.ENGINE_LEN, kv_cache_config=kv)
        eng.cache_prefix(prefix)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for r in requests[:cs.ENGINE_BATCH]:
                eng.add(r["prompt"])
            torch.cuda.synchronize()
        dev_ms = cs.device_time_by_kernel(prof)
        kernel_ms = sum(dev_ms.get(k, 0.0) for k in names)
        out[name + "_admissions"] = dict(admissions=cs.ENGINE_BATCH, wall_s=wall_s, kernel_device_ms=kernel_ms,
                                         kernel_device_ms_per_admission=kernel_ms / cs.ENGINE_BATCH,
                                         prompt_tokens=sum(len(r["prompt"]) for r in requests[:cs.ENGINE_BATCH]),
                                         device_ms=dev_ms)
        print(f"[{args.label}] {name}: {args.kernel} {kernel_ms:.3f} device ms over {cs.ENGINE_BATCH} admissions, "
              f"{wall_s:.3f} s on the host clock, device busy {dev_ms.get('busy', 0.0):.2f} ms [{card}]", flush=True)

    if "host" in paths:  # the wrapper's host time a call at its decode shape, 200 calls queued unsynchronised
        if "mx_cached_attention_dmajor" in names:
            from torchmx_tpu_torch.ops import cuda_attention as ca

            a = cs._to_dmajor(cs._attn_case(dev, torch.Generator(dev).manual_seed(3), 32, 32, 8, 128, 256, 1,
                                            [192] * 32, "float4_e2m1"))
            call, shape = (lambda: ca.mx_cached_attention_dmajor(*a[:5], 191, 192, *a[7:])), "decode b=32 L=256 fp4"
        elif "mx_cached_attention_chunkdot" in names:
            from torchmx_tpu_torch.ops import cuda_attention as ca

            ragged = [0] + [1 + (1023 * i) // 30 for i in range(31)]
            a = cs._attn_case(dev, torch.Generator(dev).manual_seed(3), 32, 32, 8, 128, 1024, 1, ragged, "int8",
                              never_written=True)[:8]
            call, shape = (lambda: ca.mx_cached_attention_chunkdot(*a)), "decode b=32 L=1024 int8 seq ragged"
        elif "mx_cached_attention_int8dot" in names:
            from torchmx_tpu_torch.ops import cuda_attention as ca

            ragged = [0] + [1 + (1023 * i) // 30 for i in range(31)]
            a = cs._to_dmajor(cs._attn_case(dev, torch.Generator(dev).manual_seed(3), 32, 32, 8, 128, 1024, 1,
                                            ragged, "int8", never_written=True))[:8]
            call, shape = (lambda: ca.mx_cached_attention_int8dot(*a)), "decode b=32 L=1024 int8 ragged"
        elif "mx_mla_attention_int8dot" in names:
            from torchmx_tpu_torch.ops import cuda_mla

            c = cs._mla_case(dev, torch.Generator(dev).manual_seed(3), 32, 16, 256, 1, [192] * 32, "int8",
                             layout="dmajor")
            a = (c["q_lat"], c["q_rot"], *c["cache"].buffers)
            call = lambda: cuda_mla.mx_mla_attention_int8dot(*a, 191, 192, c["sm"])  # noqa: E731
            shape = "GKD decode b=32 L=256 kv_len 192 (numbers)"
        elif "mx_mla_attention" in names:
            from torchmx_tpu_torch.ops import cuda_mla

            c = cs._mla_case(dev, torch.Generator(dev).manual_seed(3), 32, 16, 1024, 1, cs.MLA_RAGGED, "int8")
            a = cs._mla_args(c)
            call, shape = (lambda: cuda_mla.mx_mla_attention(*a)), "decode b=32 L=1024 int8"
        else:
            raise ValueError(f"no host-time shape for {names}")
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out["host_us_per_call"] = dict(shape=shape, us=host_us)
        print(f"[{args.label}] {args.kernel} host us a call ({shape}): {host_us:.2f} [{card}]", flush=True)

    if any(p in paths for p in LLAMA_PATHS):
        layers = args.layers or cs.LLAMA3_8B["num_hidden_layers"]
        if any(p in paths for p in ("g", "f", "d", "e")):
            model = cs.build_model(dev, card, layers)
            if "g" in paths:
                slice_path("g", model, "float8_e4m3", "fp4", layers, cs.halves_launches_per_step(layers))
            if "f" in paths:
                with cs.kv_env(*cs.CACHES["float4_e2m1 d-major"][1:]):
                    slice_path("f", model, "float4_e2m1 d-major", "fp4", layers, cs.halves_launches_per_step(layers))
            if "d" in paths:
                with cs.kv_env(*cs.CACHES["int8 d-major int8dot"][1:]):
                    engine_path("d", model, "int8 d-major int8dot", "fp4", layers)
                    admissions("d", model, "int8 d-major int8dot")
            if "e" in paths:
                engine_path("e", model, "int8", "fp4", layers)
                admissions("e", model, "int8")
            del model
            torch.cuda.empty_cache()
        if "w" in paths:
            weights, acts, _, _ = cs.FORMATS["W8A8 int8 cache"]
            model = cs.build_model(dev, card, layers, weights=weights, acts=acts)
            engine_path("w", model, "int8", "w8a8", layers)
            del model
            torch.cuda.empty_cache()
        if "pd" in paths:
            weights, acts, cache, knobs = cs.FORMATS["MXFP8 FP8_DOT fp8 cache"]
            with cs.env_knobs(**knobs):
                model = cs.build_model(dev, card, layers, weights=weights, acts=acts)
                slice_path("pd", model, cache, "MXFP8 FP8_DOT fp8 cache", layers)
            del model
            torch.cuda.empty_cache()
    if "gm" in paths:
        layers = args.layers or cs.MIXTRAL_8X7B["num_hidden_layers"]
        model = cs.build_mixtral(dev, card, layers)
        slice_path("gm", model, "int8", "Mixtral fp4 grouped", layers, cs.mixtral_launches_per_step(layers))
        del model
        torch.cuda.empty_cache()
    if any(p in paths for p in MOONLIGHT_PATHS):
        layers = args.layers or cs.MOONLIGHT_16B["num_hidden_layers"]
        model = cs.build_moonlight(dev, card, layers)
        if "gk" in paths:
            slice_path("gk", model, "int8", "Moonlight fp4 grouped", layers, cs.moonlight_launches_per_step(model.config))
        if "ek" in paths:
            engine_path("ek", model, "int8", "moonlight", layers)
        if "gkd" in paths:
            with cs.kv_env(*cs.CACHES["int8 d-major int8dot"][1:]):
                slice_path("gkd", model, "int8 d-major int8dot", "Moonlight fp4 grouped", layers)
        del model
        torch.cuda.empty_cache()

    if any(p in paths for p in QWEN2_PATHS):
        layers = args.layers or cs.QWEN2_7B["num_hidden_layers"]
        model = cs.build_qwen2(dev, card, cs.QWEN2_7B, layers)
        if "q" in paths:
            engine_path("q", model, "int8", "fp4", layers)
        if "qd" in paths:
            with cs.kv_env(*cs.CACHES["int8 d-major int8dot"][1:]):
                slice_path("qd", model, "int8 d-major int8dot", "Qwen2-7B fp4", layers,
                           cs.qwen2_launches_per_step(layers, int8dot=True))
        del model
        torch.cuda.empty_cache()

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"paths_ab_{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
