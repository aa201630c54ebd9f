"""B14 as the Moonlight int8 d-major path calls it, and that path's decode
step beside the seq-latent path's, measured by one checkout's own
``chip_smoke.py``.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/moonlight_int8dot_ab.py [--root DIR] [--label NAME] [--layers 27]

``--root`` imports ``chip_smoke`` and ``torchmx_tpu_torch`` from another
checkout (for instance a parent commit unpacked by ``git archive`` into a
git-ignored directory), so that two versions run the same phases on one card
in one call; run them in turns (parent, change, change, parent).  The phases:
B14's check and timing rows at its decode shapes (``ms``: the kernel alone;
``ms_with_q_quantize``: as the path calls it, its query quantized as the
checkout quantizes it), then Moonlight-16B-A3B built from a seed at
``--layers`` deep and ``generate`` at b=32 over the int8 seq latent (B13)
and over the int8 d-major latent with ``TORCHMX_ATTN_INT8_DOT=1`` (B14),
each with tok/s, the host-clock decode step, device ms per step by kernel
and the idle share.  Writes ``chiprun_out/moonlight_int8dot_<label>.json``.
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
    ap.add_argument("--layers", type=int, default=27)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("moonlight_int8dot_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_lib

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not from {root}")
    dev, card = torch.device("cuda"), cs.card_line()
    cuda_lib.build_all()
    b14, b14_rows = cs.check_mla_int8dot_kernel(dev, cs.Timer(dev), torch.Generator(dev).manual_seed(1234))
    model = cs.build_moonlight(dev, card, args.layers)
    _, gk = cs.run_slice(model, dev, card, "int8", batches=(32,), weights="Moonlight fp4 grouped")
    with cs.kv_env(*cs.CACHES["int8 d-major int8dot"][1:]):
        _, gkd = cs.run_slice(model, dev, card, "int8 d-major int8dot", batches=(32,), weights="Moonlight fp4 grouped")
    out = dict(label=args.label, root=root, card=card, layers=args.layers, b14=b14, b14_rows=b14_rows,
               gk_b32=gk[32], gkd_b32=gkd[32])
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"moonlight_int8dot_{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    for name, r in (("GK", gk[32]), ("GKD", gkd[32])):
        dev_ms = r.get("device_ms_per_decode_step", {})
        print(f"[{args.label}] {name} b=32: {r['tokens_per_s']:.1f} tok/s, host step {r['generate_decode_step_ms']:.2f} ms, "
              f"pytorch {dev_ms.get('pytorch')} ms, busy {dev_ms.get('busy')} ms, idle {r.get('device_idle_share')} "
              f"[{card}]", flush=True)
    pick = next(r for r in b14_rows if r["case"].startswith("decode b=32"))
    print(f"[{args.label}] B14 b=32 L=1024: {json.dumps(pick)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
