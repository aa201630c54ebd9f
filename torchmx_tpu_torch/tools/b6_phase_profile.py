"""Where B6's mainloop spends its clock cycles, on the card.

Builds ``csrc/mx_matmul_1byte.cu`` with ``-DB6_PHASE_PROFILE`` into a library
of its own, runs the kernel on int8 and e4m3 weights at the Llama-3-8B
linears' prefill shapes (each CTA walking its K splits), and prints, for a
thread of each warpgroup, the cycles per K stage of each mainloop phase and
the kernel's time.  Run from the repository root on a machine with one card:

    python3 torchmx_tpu_torch/tools/b6_phase_profile.py [M ...]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from torchmx_tpu_torch.mx_array import MXTensor  # noqa: E402
from torchmx_tpu_torch.ops import cuda_lib  # noqa: E402
from torchmx_tpu_torch.ops import cuda_matmul_formats as kf  # noqa: E402

PHASES = ("wgmma start", "barrier + TMA start + stage wait", "fetch + decode", "wgmma wait", "partial adds + flush")
SHAPES = {"gate_proj/up_proj": (4096, 14336), "down_proj": (14336, 4096), "q_proj/o_proj": (4096, 4096)}


def main(ms) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("b6_phase_profile: no CUDA device")
    lib, dev = cuda_lib.build_variant("mx_matmul_1byte", "-DB6_PHASE_PROFILE"), torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (K, N) in SHAPES.items():
        w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        for elem in ("int8", "float8_e4m3"):
            t = MXTensor.to_mx(w, elem).T
            for M in ms:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                counters = torch.zeros(16, dtype=torch.int64, device=dev)
                splits = kf.plan_1byte(M, N, K, sms).splits

                def launch():
                    rc = lib.mx_matmul_1byte_launch(x.data_ptr(), t.data.data_ptr(), t.scale_e8m0.data_ptr(),
                                                    out.data_ptr(), counters.data_ptr(), M, N, K,
                                                    cuda_lib.ELEM_CODES[elem], -1, splits, 1,
                                                    torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                launch()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                torch.cuda.synchronize()
                ms_ = start.elapsed_time(end)
                counters.zero_()
                launch()
                v = counters.tolist()
                for who, o in (("warpgroup 0", 0), ("warpgroup 1", 8)):
                    stages = max(v[o + 7], 1)
                    parts = ", ".join(f"{name} {v[o + i] / stages:.0f}" for i, name in enumerate(PHASES))
                    print(f"{label} {elem} M={M} N={N} K={K}: {ms_:.4f} ms (instrumented); {who}: "
                          f"{v[o + 6] / stages:.0f} cycles per K stage: {parts}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2048])
