"""Where B13's kernel-vs-plain gate sits: the sound kernel and the planted
combine fault (``drop_last_chunk``: the last live chunk of a tile left out)
against the plain version, at every ``chip_smoke.MLA_CASES`` and
``MLA_SPLIT_CASES`` shape in all six latent formats and at two probes whose
last live chunk holds one position (kv_len = S + 1, 2S + 1, 3S + 1 at L =
1024, decode and a prefill of 64).  Each reading is the max abs error and
the worst row's relative L2 error (``chip_smoke.worst_row_rel``), over the
case and, for the fault, over each batch row alone.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/b13_gate_readings.py

Writes ``chiprun_out/b13_gate_readings.json``.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("b13_gate_readings: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_mla

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1234)
    card = cs.card_line()
    print(card, flush=True)
    S = cuda_mla.mla_chunk(1024)
    probes = [("fault probe decode L=1024 kv=3S+1,S+1,2S+1", 3, 16, 1024, 1, [3 * S + 1, S + 1, 2 * S + 1]),
              ("fault probe prefill sq=64 L=1024 kv=S+1,2S+1", 2, 16, 1024, 64, [S + 1, 2 * S + 1])]
    out = dict(card=card, readings=[])
    for label, b, n, L, sq, kv in cs.MLA_CASES + cs.MLA_SPLIT_CASES + probes:
        for elem in cs.MLA_FORMATS:
            c = cs._mla_case(dev, gen, b, n, L, sq, kv, elem)
            args = cs._mla_args(c)
            got = cuda_mla.mx_mla_attention(*args)
            ref = cuda_mla.mx_mla_attention_plain(*args)
            drop = cuda_mla.mx_mla_attention(*args, drop_last_chunk=True)
            r = dict(case=label, elem=elem, abs=(got.float() - ref.float()).abs().max().item(),
                     rel=cs.worst_row_rel(got, ref), fault_abs=(drop.float() - ref.float()).abs().max().item(),
                     fault_rel=cs.worst_row_rel(drop, ref))
            if b > 1:
                r["fault_abs_rows"] = [(drop[i].float() - ref[i].float()).abs().max().item() for i in range(b)]
                r["fault_rel_rows"] = [cs.worst_row_rel(drop[i], ref[i]) for i in range(b)]
            print(json.dumps(r), flush=True)
            out["readings"].append(r)
            del c, args
    sound = out["readings"]
    print(f"sound: abs <= {max(r['abs'] for r in sound):.3e}, row rel <= {max(r['rel'] for r in sound):.3e} "
          f"[{card}]", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "b13_gate_readings.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
