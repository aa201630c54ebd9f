"""B12's two served paths, measured by one checkout's own ``chip_smoke.py``:
Mixtral-8x7B ``generate`` at b=32 (MXFP4 grouped experts as int8-domain
codes, int8 seq cache, 32 layers) and Moonlight-16B-A3B ``generate`` at b=32
(the same experts' format, int8 seq latent, 27 layers); and, as a control
that B12 does not run, the Llama-3-8B-width ``generate`` at b=32 (MXFP4,
fp8 cache, ``chip_smoke.LLAMA_LAYERS`` layers).

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/b12_paths_ab.py [--root DIR] [--label NAME] [--paths mixtral,moonlight,llama]

``--root`` imports ``chip_smoke`` and ``torchmx_tpu_torch`` from another
checkout (for instance a parent commit unpacked by ``git archive`` into a
git-ignored directory), so that two versions run the same phases on one card
in one call; run them in turns (parent, change, change, parent).  Each path
is ``chip_smoke.run_slice`` at b=32: tok/s over prompt 64 + 128 new tokens,
the decode step's launches, and a torch.profiler window of 8 decode steps
(device ms a step by kernel: B12 with its split reduce and, in a parent,
its row marks; busy ms; the idle share).  Writes
``chiprun_out/b12_paths_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

B12_NAMES = ("mx_grouped_matmul", "split-K reduce of B12", "row marks of B12")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout to import chip_smoke and the package from")
    ap.add_argument("--label", default="change")
    ap.add_argument("--paths", default="mixtral,moonlight,llama", help="the paths to run, comma-separated")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("b12_paths_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_lib

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not from {root}")
    dev, card = torch.device("cuda"), cs.card_line()
    cuda_lib.build_all()
    out = dict(label=args.label, root=root, card=card)

    def record(name, model, cache, weights, layers, want=None):
        _, res = cs.run_slice(model, dev, card, cache, batches=(32,), weights=weights, want=want)
        r = res[32]
        dev_ms = r.get("device_ms_per_decode_step")
        b12 = sum(dev_ms.get(k, 0.0) for k in B12_NAMES) if isinstance(dev_ms, dict) else None
        out[name] = dict(layers=layers, tokens_per_s=r["tokens_per_s"], b12_device_ms_per_step=b12,
                         busy_ms_per_step=dev_ms.get("busy") if isinstance(dev_ms, dict) else None,
                         device_idle_share=r.get("device_idle_share"), peak_gib=r["peak_gib"],
                         launches_per_decode_step=r["launches_per_decode_step"], device_ms_per_decode_step=dev_ms)
        print(f"[{args.label}] {name} b=32 at {layers} layers: {r['tokens_per_s']:.1f} tok/s, B12 {b12} device ms a "
              f"step, busy {out[name]['busy_ms_per_step']}, idle {r.get('device_idle_share')}, peak "
              f"{r['peak_gib']:.2f} GiB [{card}]", flush=True)

    paths = args.paths.split(",")
    if "mixtral" in paths:
        layers = cs.MIXTRAL_8X7B["num_hidden_layers"]
        model = cs.build_mixtral(dev, card, layers)
        record("mixtral", model, "int8", "Mixtral fp4 grouped", layers, cs.mixtral_launches_per_step(layers))
        del model
        torch.cuda.empty_cache()
    if "moonlight" in paths:
        layers = cs.MOONLIGHT_16B["num_hidden_layers"]
        model = cs.build_moonlight(dev, card, layers)
        record("moonlight", model, "int8", "Moonlight fp4 grouped", layers,
               cs.moonlight_launches_per_step(model.config))
        del model
        torch.cuda.empty_cache()
    if "llama" in paths:
        model = cs.build_model(dev, card, cs.LLAMA_LAYERS)
        record("llama", model, "float8_e4m3", "fp4", cs.LLAMA_LAYERS, cs.halves_launches_per_step(cs.LLAMA_LAYERS))
        del model
        torch.cuda.empty_cache()

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"b12_paths_{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
