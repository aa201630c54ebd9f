"""B13's two served paths, measured by one checkout's own ``chip_smoke.py``:
Moonlight-16B-A3B ``generate`` at b=32 over the int8 seq latent (GK: prompt
64 + 128 new tokens over a 256-position cache) and the Moonlight engine
stream over the same latent (EK: 32 slots of 1024 positions, 48 requests,
with all of ``chip_smoke.run_engine``'s checks), at 27 layers, MXFP4 weights
(grouped experts as int8-domain codes), MXFP8 activations.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/b13_paths_ab.py [--root DIR] [--label NAME] [--paths gk,ek]

``--root`` imports ``chip_smoke`` and ``torchmx_tpu_torch`` from another
checkout (for instance a parent commit unpacked by ``git archive`` into a
git-ignored directory), so that two versions run the same phases on one card
in one call; run them in turns (parent, change, change, parent).  Each path
reports tok/s, B13's device ms a step (``mx_mla_attention``), the device's
busy ms a step and idle share, from the torch.profiler window of 8 decode
steps that ``run_slice`` (GK) and ``run_engine`` (EK) take, the launches
of a decode step, the path's peak device memory (``max_memory_allocated``
over its run, the model's weights included) and the bytes that B13's
per-device combine workspace and tickets hold after it; ``host`` times the wrapper's host work a call (200 calls
at EK's decode shape queued without a synchronisation, host clock).  Writes
``chiprun_out/b13_paths_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout to import chip_smoke and the package from")
    ap.add_argument("--label", default="change")
    ap.add_argument("--paths", default="host,gk,ek", help="the paths to run, comma-separated")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("b13_paths_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_lib

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not from {root}")
    dev, card = torch.device("cuda"), cs.card_line()
    cuda_lib.build_all()
    layers = cs.MOONLIGHT_16B["num_hidden_layers"]
    model = cs.build_moonlight(dev, card, layers)
    out = dict(label=args.label, root=root, card=card, layers=layers)

    def scratch_bytes():  # B13's combine workspace and tickets on every device (none before the KV split)
        from torchmx_tpu_torch.ops import cuda_mla

        held = getattr(cuda_mla, "_B13_SCRATCH", {}).values()
        return sum(t.numel() * t.element_size() for pair in held for t in pair)

    def record(name, r, dev_ms, idle, launches):
        timed = isinstance(dev_ms, dict)
        out[name] = dict(tokens_per_s=r["tokens_per_s"], b13_device_ms_per_step=dev_ms.get("mx_mla_attention")
                         if timed else None, busy_ms_per_step=dev_ms.get("busy") if timed else None,
                         device_idle_share=idle, peak_gib=r["peak_gib"], b13_scratch_bytes=scratch_bytes(),
                         launches_per_decode_step=launches, device_ms_per_step=dev_ms)
        print(f"[{args.label}] {name} at {layers} layers: {r['tokens_per_s']:.1f} tok/s, B13 "
              f"{out[name]['b13_device_ms_per_step']} device ms a step, busy {out[name]['busy_ms_per_step']}, "
              f"idle {idle}, peak {r['peak_gib']:.3f} GiB, B13 workspace {out[name]['b13_scratch_bytes']} bytes "
              f"[{card}]", flush=True)

    paths = args.paths.split(",")
    if "host" in paths:  # the wrapper's host time a call at EK's decode shape, 200 calls queued unsynchronised
        import time

        from torchmx_tpu_torch.ops import cuda_mla

        c = cs._mla_case(dev, torch.Generator(dev).manual_seed(3), 32, 16, 1024, 1, cs.MLA_RAGGED, "int8")
        call_args = cs._mla_args(c)
        for _ in range(10):
            cuda_mla.mx_mla_attention(*call_args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            cuda_mla.mx_mla_attention(*call_args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out["host_us_per_b13_call"] = host_us
        print(f"[{args.label}] B13 host us a call (decode b=32 L=1024, int8): {host_us:.2f} [{card}]", flush=True)
    if "gk" in paths:
        _, res = cs.run_slice(model, dev, card, "int8", batches=(32,), weights="Moonlight fp4 grouped",
                              want=cs.moonlight_launches_per_step(model.config))
        r = res[32]
        record("gk_b32", r, r.get("device_ms_per_decode_step"), r.get("device_idle_share"),
               r["launches_per_decode_step"])
    if "ek" in paths:
        r = cs.run_engine(model, dev, card, "int8", weights="moonlight")
        record("ek_engine", r, r.get("device_ms_per_step"), r.get("device_idle_share"),
               r["launches_per_decode_step"])
    del model
    torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"b13_paths_{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
