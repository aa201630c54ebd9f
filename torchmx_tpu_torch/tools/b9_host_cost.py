"""Host time of one B9 call at Llama-3-8B's decode shapes (M = 32; q/o,
k/v, gate/up, down; int8 and e4m3 codes), from one checkout or another.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/b9_host_cost.py [--root DIR] [--label NAME]

``--root`` imports ``torchmx_tpu_torch`` from another checkout (for instance
a parent commit unpacked by ``git archive`` into a git-ignored directory),
so that versions are compared on one card in one call.  Three readings a
shape, each the host microseconds a call, medians of seven runs of 100
calls queued behind a sleeping kernel (so that no call waits for the card):

* ``served``: ``cuda_matmul_formats.mx_matmul_int8dot`` as a decode step
  calls it (K1, the kernel and, where the plan has one, the split reduce);
* ``served_idle``: the same call with the card idle (each call timed alone
  after a synchronisation), as most calls of a host-bound step find it;
* ``c_launch``: B9's C entry point alone through ``cuda_lib.launch`` on
  operands allocated once, as the served call makes it: the kernel's launch
  and, where the plan has one, the split reduce's (for the TMA kernel also
  the four tensor maps' encoding and its 0.5 KB parameter block).

Prints one line a shape and writes ``chiprun_out/b9_host_cost_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = {"q_proj/o_proj": (4096, 4096), "k_proj/v_proj": (4096, 1024), "gate_proj/up_proj": (4096, 14336),
          "down_proj": (14336, 4096)}  # (K, N)
M = 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout to import the package from")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("b9_host_cost: no CUDA device", file=sys.stderr)
        return 1
    from torchmx_tpu_torch.ops import cuda_lib
    from torchmx_tpu_torch.ops import cuda_matmul as cm
    from torchmx_tpu_torch.ops import cuda_matmul_formats as kf
    from torchmx_tpu_torch.ops import cuda_quantize as cq
    from torchmx_tpu_torch.ops.cuda_matmul import sm_count

    if not kf.__file__.startswith(root):
        raise RuntimeError(f"the package came from {kf.__file__}, not from {root}")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cuda_lib.build_all()

    def host_us(fn, calls=100, runs=7):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(runs):
            torch.cuda._sleep(100_000_000)  # tens of ms: the calls below queue behind it
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(out), out

    def host_us_idle(fn, calls=100, runs=7):
        """The same with the card idle at every call: each call timed alone
        after a synchronisation, as a host-bound step makes most of them."""
        for _ in range(10):
            fn()
        out = []
        for _ in range(runs):
            total = 0.0
            for _ in range(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                total += time.perf_counter() - t0
            out.append(total / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(out), out

    rows = []
    for label, (K, N) in SHAPES.items():
        for fp8 in (False, True):
            code = torch.uint8 if fp8 else torch.int8
            w = torch.randint(-100, 100, (K, N), device=dev, dtype=torch.int16).to(torch.int8).view(code)
            sw = torch.full((K // 32, N), 127, device=dev, dtype=torch.uint8)
            x = torch.randn(M, K, device=dev).to(torch.bfloat16)
            row = dict(linear=label, M=M, fmt="float8_e4m3" if fp8 else "int8")
            row["served"], row["served_runs"] = host_us(lambda: kf.mx_matmul_int8dot(x, w, sw, fp8))
            row["served_idle"], row["served_idle_runs"] = host_us_idle(lambda: kf.mx_matmul_int8dot(x, w, sw, fp8))
            out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            fn = ("mx_matmul_fp8dot" if fp8 else "mx_matmul_int8dot") + "_launch"
            if hasattr(kf, "plan_int8dot"):  # the dot-order kernel
                plan = kf.plan_int8dot(M, N, K, sm_count(dev))
                px_t, xd = cq.mx_quantize_dot(x, row["fmt"])
                ws = torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev)
                c_args = [xd.data_ptr(), px_t.data_ptr(), w.data_ptr(), sw.data_ptr(), out.data_ptr(),
                          ws.data_ptr(), M, N, K, px_t.shape[1], plan.splits, int(plan.walk)]
                if len(cuda_lib.SIGNATURES["mx_matmul_int8dot"][fn]) == len(c_args) + 2:
                    c_args.append(1)  # the reduce in the same call, as the served call has it
                row["plan"] = dict(splits=plan.splits, walk=plan.walk)
            else:  # the mma.sync kernel, whose C entry launches its reduce itself
                _, splits = cm._plan(M, N, K, dev)
                sx, xc = cq.mx_quantize(x, row["fmt"])
                ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
                c_args = [xc.data_ptr(), sx.data_ptr(), w.data_ptr(), sw.data_ptr(), out.data_ptr(), ws.data_ptr(),
                          M, N, K, 16 if M <= 16 else 64, splits]
                row["plan"] = dict(splits=splits)
            row["c_launch"], row["c_launch_runs"] = host_us(
                lambda: cuda_lib.launch("mx_matmul_int8dot", fn, *c_args, count=False))
            print(f"[{args.label}] {label} M={M} {row['fmt']}: host us a call, served {row['served']:.2f}, "
                  f"served to an idle card {row['served_idle']:.2f}, C entry alone {row['c_launch']:.2f}", flush=True)
            rows.append(row)
            del w, sw, x
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/b9_host_cost_{args.label}.json", "w") as f:
        json.dump(dict(label=args.label, root=root, card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
