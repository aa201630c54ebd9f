"""Where a split-KV kernel's kernel-vs-plain gate sits: the sound kernel and
the planted combine fault (B13's ``drop_last_chunk``, K4's and K6's
``drop_last_share``, K5's, K7's and B14's ``drop_last_tile``: the last live
chunk, share or tile of a row left out; for K5 also ``p_from_own_tile_max``:
p rounded against its tile's own maximum, not the running one; for K4 and
K6 also ``p_from_sub_tile_max``: p rounded against the running maximum
through its 64 positions, not through JAX's tile) against the plain
version.  Each reading is the max abs error, the
worst row's relative L2 error (``chip_smoke.worst_row_rel``) and the whole
output's relative L2 error, over the case and, for the fault, over each
batch row alone.

* ``--kernel b13``: B13 at every ``chip_smoke.MLA_CASES`` and
  ``MLA_SPLIT_CASES`` shape in all six latent formats, and at two probes
  whose last live chunk holds one position (kv_len = S + 1, 2S + 1, 3S + 1
  at L = 1024, decode and a prefill of 64);
* ``--kernel k4``: K4 at the timed shapes of ``chip_smoke.
  check_attention_kernel`` (fp8) and of ``check_int8_attention_kernels``
  (int8 prefill and chunks) and at ``chip_smoke.k6_edge_cases`` in the four
  seq formats, and at ``chip_smoke.k46_fault_probes``, one batch row alone
  (the fault a probe is for in its label);
* ``--kernel k6``: K6 at the six shapes of ``chip_smoke.
  check_dmajor_attention_kernels`` and at ``chip_smoke.k6_edge_cases`` in
  all five cache formats, and at ``chip_smoke.k46_fault_probes``;
* ``--kernel k7``: K7 at the three decode shapes of ``chip_smoke.
  check_dmajor_attention_kernels`` and at ``chip_smoke.k7_edge_cases``, and
  at the probes kv_len = lt + 1 and 2 lt + 1 (lt = JAX's tile) at L = 1024
  and 8192, one batch row alone;
* ``--kernel b14``: B14 at ``chip_smoke.MLA_INT8DOT_CASES`` and at
  ``chip_smoke.b14_edge_cases``, and at the probes kv_len = lt + 1 and 2 lt +
  1 (lt = JAX's tile) at L = 1024 and 8192, one batch row alone;
* ``--kernel k5``: K5 at its four decode shapes (``chip_smoke.K5_CASES``)
  and at ``chip_smoke.k5_edge_cases`` (JAX's tiles and K5's shares) in every
  GQA group (hq = 32, 16, 8 over 8 KV heads; 8 over 1), and at
  ``chip_smoke.k5_fault_probes``, one batch row alone (the fault a probe is
  for in its label).

``--seeds n`` draws every input n times (random K, V and q from a normal
distribution, as the checks draw them) and prints the spread of the sound
and the fault readings over the draws.  Run from the repository root with
one card:

    python3 torchmx_tpu_torch/tools/gate_readings.py --kernel b13|k4|k6|k7|b14|k5 [--seeds n]

Writes ``chiprun_out/<kernel>_gate_readings.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def readings_b13(cs, dev, gen):
    from torchmx_tpu_torch.ops import cuda_mla

    S = cuda_mla.mla_chunk(1024)
    probes = [("fault probe decode L=1024 kv=3S+1,S+1,2S+1", 3, 16, 1024, 1, [3 * S + 1, S + 1, 2 * S + 1]),
              ("fault probe prefill sq=64 L=1024 kv=S+1,2S+1", 2, 16, 1024, 64, [S + 1, 2 * S + 1])]
    for label, b, n, L, sq, kv in cs.MLA_CASES + cs.MLA_SPLIT_CASES + probes:
        for elem in cs.MLA_FORMATS:
            c = cs._mla_case(dev, gen, b, n, L, sq, kv, elem)
            args = cs._mla_args(c)
            yield label, elem, b, cuda_mla.mx_mla_attention, args, cuda_mla.mx_mla_attention_plain(*args)
            del c, args


K6_FORMATS = ("float8_e4m3", "int8", "float4_e2m1", "float6_e3m2", "float6_e2m3")
RAGGED = [0] + [1 + (1023 * i) // 30 for i in range(31)]
K6_CASES = [("decode b=32 L=1024 kv_len 0..1024 ragged", 32, 1024, 1, RAGGED, True),
            ("decode b=1 L=1024 kv_len=700", 1, 1024, 1, [700], True),
            ("decode b=32 L=256 kv_len=192", 32, 256, 1, [192] * 32, False),
            ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32, False),
            ("whole b=1 L=1024 sq=384", 1, 1024, 384, [384], False),
            ("chunk b=1 L=1024 sq=128 q_off=256", 1, 1024, 128, [384], False)]


K4_CASES = [("decode b=32 L=256 kv=192", 32, 256, 1, [192] * 32, False),
            ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32, False),
            ("ragged b=4 L=1024 sq=64", 4, 1024, 64, [1024, 777, 300, 70], False),
            ("whole b=1 L=1024 sq=384", 1, 1024, 384, [384], False),
            ("chunk b=1 L=1024 sq=128 q_off=256", 1, 1024, 128, [384], False),
            ("remainder b=1 L=1024 sq=64 q_off=128", 1, 1024, 64, [192], False)]


def _k46_probes(cs, dev, gen, layout):
    from torchmx_tpu_torch.ops import cuda_attention as ca

    fn, plain = ((ca.mx_cached_attention, ca.mx_cached_attention_plain) if layout == "seq" else
                 (ca.mx_cached_attention_dmajor, ca.mx_cached_attention_dmajor_plain))
    for L, sq, kv, fault in cs.k46_fault_probes():
        args = cs._attn_case(dev, gen, 1, 32, 8, 128, L, sq, [kv], "int8", never_written=True)
        args = args if layout == "seq" else cs._to_dmajor(args)
        yield f"fault probe L={L} sq={sq} kv={kv} ({fault})", "int8", 1, fn, args, plain(*args)
        del args


def readings_k4(cs, dev, gen):
    from torchmx_tpu_torch.ops import cuda_attention as ca

    timed = K4_CASES + [(label, b, L, 1, kv, True) for label, b, L, kv in cs.K7_CASES]
    for label, b, L, sq, kv, fresh in timed + cs.k6_edge_cases():
        for elem in ca.K4_FORMATS:
            args = cs._attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, elem, never_written=fresh)
            yield label, elem, b, ca.mx_cached_attention, args, ca.mx_cached_attention_plain(*args)
            del args
    yield from _k46_probes(cs, dev, gen, "seq")


def readings_k6(cs, dev, gen):
    from torchmx_tpu_torch.ops import cuda_attention as ca

    for label, b, L, sq, kv, fresh in K6_CASES + cs.k6_edge_cases():
        for elem in K6_FORMATS:
            args = cs._to_dmajor(cs._attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, elem, never_written=fresh))
            yield label, elem, b, ca.mx_cached_attention_dmajor, args, ca.mx_cached_attention_dmajor_plain(*args)
            del args
    yield from _k46_probes(cs, dev, gen, "dmajor")


def readings_k7(cs, dev, gen):
    from torchmx_tpu_torch.ops import cuda_attention as ca

    probes = [(f"fault probe L={L} kv={kv}", 1, L, [kv]) for L in (1024, 8192)
              for kv in (ca._pick_lt(L) + 1, 2 * ca._pick_lt(L) + 1)]
    for label, b, L, kv in cs.K7_CASES + cs.k7_edge_cases() + probes:
        args = cs._to_dmajor(cs._attn_case(dev, gen, b, 32, 8, 128, L, 1, kv, "int8", never_written=True))[:8]
        yield label, "int8", b, ca.mx_cached_attention_int8dot, args, ca.mx_cached_attention_int8dot_plain(*args)
        del args


def readings_b14(cs, dev, gen):
    from torchmx_tpu_torch.ops import cuda_mla

    probes = [(f"fault probe L={L} kv={kv}", 1, 16, L, 1, [kv]) for L in (1024, 8192)
              for kv in (cuda_mla.b14_split(L)[0] + 1, 2 * cuda_mla.b14_split(L)[0] + 1)]
    for label, b, n, L, sq, kv in cs.MLA_INT8DOT_CASES + cs.b14_edge_cases() + probes:
        c = cs._mla_case(dev, gen, b, n, L, sq, kv, "int8", layout="dmajor")
        args = (c["q_lat"], c["q_rot"], *c["cache"].buffers, c["q_off"], c["kv_len"], c["sm"])
        yield label, "int8", b, cuda_mla.mx_mla_attention_int8dot, args, cuda_mla.mx_mla_attention_int8dot_plain(*args)
        del c, args


def readings_k5(cs, dev, gen):
    from torchmx_tpu_torch.ops import cuda_attention as ca

    groups = [(32, 8), (16, 8), (8, 8), (8, 1)]
    for label, b, L, kv in cs.K5_CASES + cs.k5_edge_cases():
        for hq, hkv in groups:
            args = cs._attn_case(dev, gen, b, hq, hkv, 128, L, 1, kv, "int8", never_written=True)[:8]
            yield f"{label} hq={hq} hkv={hkv}", "int8", b, ca.mx_cached_attention_chunkdot, args, \
                ca.mx_cached_attention_chunkdot_plain(*args)
            del args
    for L, kv, fault in cs.k5_fault_probes():
        args = cs._attn_case(dev, gen, 1, 32, 8, 128, L, 1, [kv], "int8", never_written=True)[:8]
        yield f"fault probe L={L} kv={kv} ({fault})", "int8", 1, ca.mx_cached_attention_chunkdot, args, \
            ca.mx_cached_attention_chunkdot_plain(*args)
        del args


# the planted faults' switches, the combine fault first
FAULT = dict(b13=("drop_last_chunk",), k4=("drop_last_share", "p_from_sub_tile_max"),
             k6=("drop_last_share", "p_from_sub_tile_max"), k7=("drop_last_tile",), b14=("drop_last_tile",),
             k5=("drop_last_tile", "p_from_own_tile_max"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(FAULT), required=True)
    ap.add_argument("--seeds", type=int, default=1, help="draws of every input (seeds 1234, 1235, ...)")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("gate_readings: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    out = dict(card=card, readings=[])
    cases = dict(b13=readings_b13, k4=readings_k4, k6=readings_k6, k7=readings_k7, b14=readings_b14,
                 k5=readings_k5)[args.kernel]
    draws = ((seed, label, *rest) for seed in range(1234, 1234 + args.seeds)
             for label, *rest in cases(cs, dev, torch.Generator(dev).manual_seed(seed)))
    for seed, label, elem, b, kernel, call_args, ref in draws:
        got = kernel(*call_args)
        r = dict(case=label, seed=seed, elem=elem, abs=(got.float() - ref.float()).abs().max().item(),
                 rel=cs.worst_row_rel(got, ref), l2=cs._rel(got, ref))
        for i, fault in enumerate(FAULT[args.kernel]):
            bad = kernel(*call_args, **{fault: True})
            key = "fault" if i == 0 else fault  # fault_abs / fault_rel: the combine fault's
            r[f"{key}_abs"] = (bad.float() - ref.float()).abs().max().item()
            r[f"{key}_rel"] = cs.worst_row_rel(bad, ref)
            r[f"{key}_l2"] = cs._rel(bad, ref)
            if b > 1:
                r[f"{key}_abs_rows"] = [(bad[i].float() - ref[i].float()).abs().max().item() for i in range(b)]
                r[f"{key}_rel_rows"] = [cs.worst_row_rel(bad[i], ref[i]) for i in range(b)]
        print(json.dumps(r), flush=True)
        out["readings"].append(r)
    sound = out["readings"]
    probes = [r for r in sound if r["case"].startswith("fault probe")]

    def probe_key(r):  # the fault the probe is for (the combine fault unless its label names one)
        return next((f for f in FAULT[args.kernel][1:] if f in r["case"]), "fault")

    def probe_rel(r):
        return min(r.get(f"{probe_key(r)}_rel_rows", [r[f"{probe_key(r)}_rel"]]))

    print(f"sound: abs <= {max(r['abs'] for r in sound):.3e}, row rel <= {max(r['rel'] for r in sound):.3e}; "
          f"the fault at the probes: row rel >= {min(probe_rel(r) for r in probes):.3e} [{card}]", flush=True)
    if args.seeds > 1:  # the spread over the draws: each draw's worst sound and least fault readings
        spread = {}
        for r in sound:
            d = spread.setdefault(r["seed"], dict(sound_rel=0.0, sound_l2=0.0))
            d["sound_rel"], d["sound_l2"] = max(d["sound_rel"], r["rel"]), max(d["sound_l2"], r["l2"])
            if r in probes:
                k = probe_key(r)
                d[f"{k}_rel"] = min(d.get(f"{k}_rel", float("inf")), probe_rel(r))
                d[f"{k}_l2"] = min(d.get(f"{k}_l2", float("inf")), r[f"{k}_l2"])
        out["spread"] = spread
        print(f"per draw (seed: worst sound row rel, least reading of each fault at its probes): "
              f"{json.dumps(spread)}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"{args.kernel}_gate_readings.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
