"""B9's two served paths at Llama-3-8B width, measured by one checkout's own
``chip_smoke.py``: the W8A8 engine over the int8 seq cache (W: B9 at every
decode step) and ``generate`` at b=32 with MXFP8 weights under
``TORCHMX_FP8_DOT=1`` over the fp8 cache (PD: B9-fp8 at every decode step).

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/b9_paths_ab.py [--root DIR] [--label NAME] [--layers 32]

``--root`` imports ``chip_smoke`` and ``torchmx_tpu_torch`` from another
checkout (for instance a parent commit unpacked by ``git archive`` into a
git-ignored directory), so that two versions run the same phases on one card
in one call; run them in turns (parent, change, change, parent).  W: the
seeded stream of 48 requests over 32 slots of 1024 positions, whole
admissions over the cached prefix (tok/s, the full-batch step's median on
the host clock), then a torch.profiler window of 8 full-batch steps (device
ms per step by kernel, the idle share).  PD: ``run_slice`` at b=32 (tok/s,
device ms per decode step by kernel, the idle share).  Writes
``chiprun_out/b9_paths_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout to import chip_smoke and the package from")
    ap.add_argument("--label", default="change")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("b9_paths_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.models.serve import DecodeEngine
    from torchmx_tpu_torch.ops import cuda_lib

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not from {root}")
    dev, card = torch.device("cuda"), cs.card_line()
    cuda_lib.build_all()
    out = dict(label=args.label, root=root, card=card, layers=args.layers)

    weights, acts, cache, _ = cs.FORMATS["W8A8 int8 cache"]
    model = cs.build_model(dev, card, args.layers, weights=weights, acts=acts)
    kv = cs.quant_configs(cs.CACHES[cache][0])[2]
    prefix, requests = cs.make_requests(model.config.vocab_size, seed=7)

    def engine():
        eng = DecodeEngine(model, cs.ENGINE_BATCH, cs.ENGINE_LEN, kv_cache_config=kv)
        eng.cache_prefix(prefix)
        return eng

    cs.drive(engine(), [dict(requests[4], n_new=4)])  # warm-up
    torch.cuda.synchronize()
    run = cs.drive(engine(), requests)
    full = [st["ms"] for st in run["steps"] if st["rows"] == cs.ENGINE_BATCH]
    w = dict(tokens=run["tokens"], seconds=run["seconds"], tokens_per_s=run["tokens"] / run["seconds"],
             full_batch_step_ms_median=statistics.median(full))
    w.update(cs.engine_profile(model, kv, requests, prefix, w["full_batch_step_ms_median"]))
    out["W"] = w
    del model
    torch.cuda.empty_cache()

    weights, acts, cache, knobs = cs.FORMATS["MXFP8 FP8_DOT fp8 cache"]
    with cs.env_knobs(**knobs):
        model = cs.build_model(dev, card, args.layers, weights=weights, acts=acts)
        _, res = cs.run_slice(model, dev, card, cache, batches=(32,), weights="MXFP8 FP8_DOT fp8 cache")
    out["PD"] = res[32]
    del model
    torch.cuda.empty_cache()

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"b9_paths_{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    pd = out["PD"]
    print(f"[{args.label}] W engine W8A8 at {args.layers} layers: {w['tokens_per_s']:.1f} tok/s, full-batch step "
          f"{w['full_batch_step_ms_median']:.2f} ms, device ms a step {json.dumps(w.get('device_ms_per_step'))}, "
          f"idle {w.get('device_idle_share')} [{card}]", flush=True)
    print(f"[{args.label}] PD generate b=32 at {args.layers} layers: {pd['tokens_per_s']:.1f} tok/s, device ms a step "
          f"{json.dumps(pd.get('device_ms_per_decode_step'))}, idle {pd.get('device_idle_share')} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
