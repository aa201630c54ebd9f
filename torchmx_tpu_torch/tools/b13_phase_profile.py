"""Where B13's time goes: ``csrc/mx_mla.cu`` rebuilt with parts cut out, and
with other KV chunk sizes, timed at ``chip_smoke.MLA_CASES`` over the int8
seq latent.  The cut builds give wrong results; they only time what is left.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/b13_phase_profile.py [--chunks-only]

Builds (each from a patched copy of the source written under the package's
git-ignored ``_build/``; the source itself is not touched):

* ``shipped``: the kernel as it is;
* ``no_scores``: without the 36 score wgmmas of a tile;
* ``no_decode``: every position of a tile decoded as 0 (no code is read);
* ``data_path``: neither the dots nor the decode (copies, barriers, the
  softmax's instructions, the epilogue and the combine);
* ``stream``: ``data_path`` without the softmax (the copies and barriers);
* ``no_copies``: ``data_path`` with the producer arriving on each stage
  without copying (the consumers' side alone);
* ``no_tiles``: no tile at all (the CTA's launch, Q load, epilogue and
  combine);
* ``S=...``: the shipped kernel at another chunk size (``mla_chunk``
  patched), where it gives at most 64 chunks; besides ``MLA_CASES``, decode
  at b=32 over caches of 2048 and 4096 positions (kv_len 1 .. L over the
  rows), and generate's decode steps as it calls B13 (b=32 over its
  256-position cache, q_off and kv_len numbers, kv_len 65 .. 192 at a stride
  of 16: ``gk_decode``, the mean a call and each step).

``--chunks-only`` times the chunk sizes alone (no cut builds).

Times: ``chip_smoke.Timer`` (median of 20, L2 flushed, the device asleep
while the host enqueues).  Writes ``chiprun_out/b13_phase_profile.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

CUTS = {"no_scores": ["NO_SCORES"], "no_decode": ["NO_DECODE"],
        "data_path": ["NO_SCORES", "NO_PV", "NO_DECODE"], "stream": ["NO_SCORES", "NO_PV", "NO_DECODE", "NO_SOFTMAX"],
        "no_copies": ["NO_SCORES", "NO_PV", "NO_DECODE", "NO_COPY"], "no_tiles": ["NO_TILES"]}


def _guard(s: str, start: str, end: str, flag: str) -> str:
    a = s.index(start)
    b = s.index(end, a) + len(end)
    return s[:a] + f"#ifndef {flag}\n" + s[a:b] + "\n#endif\n" + s[b:]


def _replace(s: str, old: str, new: str) -> str:
    if old not in s:
        raise RuntimeError(f"the kernel source changed: {old!r} not found")
    return s.replace(old, new)


def patched_source(src: str) -> str:
    """The kernel with #ifndef guards around the score wgmmas (NO_SCORES),
    the P.lat wgmmas (NO_PV), the decode of a live position (NO_DECODE), the
    softmax (NO_SOFTMAX), the copies (NO_COPY) and the tile count
    (NO_TILES)."""
    s = _guard(src, "    mx::wgmma_fence();\n#pragma unroll\n    for (int p = 0; p < kPanels; ++p)", "p | kk);\n",
               "NO_SCORES")
    s = _guard(s, "    mx::wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < 2; ++kk)",
               "v_rot ? 0 : kTPanel, 1024), 1);\n      }\n", "NO_PV")
    s = _replace(s, "    if (pos0 + p < kv_len) {", "#ifdef NO_DECODE\n    if (false) {\n#else\n"
                 "    if (pos0 + p < kv_len) {\n#endif")
    s = _replace(s, "    float alpha[2];\n#pragma unroll\n    for (int h = 0; h < 2; ++h) {",
                 "    float alpha[2] = {1.f, 1.f};\n#ifndef NO_SOFTMAX\n"
                 "#pragma unroll\n    for (int h = 0; h < 2; ++h) {")
    s = _replace(s, "      m_run[h] = m_new;\n    }\n", "      m_run[h] = m_new;\n    }\n#endif\n")
    s = _guard(s, "      mx::mbar_expect_tx(full, G::stage);", "kSP * G::rot_sc, full);\n      }\n", "NO_COPY")
    s = _replace(s, "kSP * G::rot_sc, full);\n      }\n\n#endif\n",
                 "kSP * G::rot_sc, full);\n      }\n\n#else\n      mx::mbar_arrive(full);\n#endif\n")
    return _replace(s, "  const int nt = t_end > c0 ? (t_end - c0 + kT - 1) / kT : 0;",
                    "#ifdef NO_TILES\n  const int nt = 0;\n#else\n"
                    "  const int nt = t_end > c0 ? (t_end - c0 + kT - 1) / kT : 0;\n#endif")


CHUNKS = (32, 64, 128, 256, 512, 1024)
GK_KV = (65, 81, 97, 113, 129, 145, 161, 177, 192)  # generate's decode: prompt 64 + 128 tokens, L = 256


def main() -> int:
    chunks_only = "--chunks-only" in sys.argv[1:]
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("b13_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_lib, cuda_mla

    cuda_lib.build_all()
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_path = cuda_lib.BUILD_DIR / f"b13_phase_profile_{os.getpid()}.cu"
    src_path.write_text(patched_source((cuda_lib.CSRC_DIR / "mx_mla.cu").read_text()))
    procs = {}
    for name, flags in ({} if chunks_only else CUTS).items():
        out = cuda_lib.BUILD_DIR / f"libmx_mla-{name}-{os.getpid()}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *(f"-D{f}" for f in flags), "-I", str(cuda_lib.CSRC_DIR),
               "-o", str(out), str(src_path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build {name} failed:\n{log.decode(errors='replace')}")
        libs[name] = cuda_lib._bind(ctypes.CDLL(str(out)), "mx_mla")

    dev, card = torch.device("cuda"), cs.card_line()
    timer, gen = cs.Timer(dev), torch.Generator(dev).manual_seed(1)
    shipped_lib, chunk_of = cuda_lib.lib("mx_mla"), cuda_mla.mla_chunk
    res = dict(card=card, cases={})

    def show(label, row):
        print(f"B13 {label}, int8: " + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                                  for k, v in row.items()}) + f" ms [{card}]", flush=True)

    def at_chunks(row, L, fn):  # fn() timed at every chunk size that gives at most 64 chunks
        try:
            for S in CHUNKS:
                if S <= L and -(-L // S) <= 64:
                    cuda_mla.mla_chunk = lambda L_, S=S: S
                    row[f"S={S}"] = fn()
        finally:
            cuda_mla.mla_chunk = chunk_of

    wide = [(f"decode b=32 L={L} ragged", 32, 16, L, 1, [1 + round(i * (L - 1) / 31) for i in range(32)])
            for L in (2048, 4096)]
    for label, b, n, L, sq, kv in cs.MLA_CASES + wide:
        c = cs._mla_case(dev, gen, b, n, L, sq, kv, "int8")
        args = cs._mla_args(c)
        row = dict(shipped=timer(lambda: cuda_mla.mx_mla_attention(*args)), shipped_chunk=chunk_of(L))
        try:
            for name, lib in libs.items():
                cuda_lib._libs["mx_mla"] = lib
                row[name] = timer(lambda: cuda_mla.mx_mla_attention(*args))
        finally:
            cuda_lib._libs["mx_mla"] = shipped_lib
        at_chunks(row, L, lambda: timer(lambda: cuda_mla.mx_mla_attention(*args)))
        res["cases"][label] = row
        show(label, row)
        del c, args

    c = cs._mla_case(dev, gen, 32, 16, 256, 1, [256] * 32, "int8")
    args = cs._mla_args(c)

    def gk_steps():  # {kv_len: ms} of generate's calls, q_off and kv_len numbers
        return {kv: timer(lambda kv=kv: cuda_mla.mx_mla_attention(*args[:6], kv - 1, kv, *args[8:])) for kv in GK_KV}

    row = dict(shipped_chunk=chunk_of(256), shipped=gk_steps())
    at_chunks(row, 256, gk_steps)
    for k, v in list(row.items()):
        if isinstance(v, dict):
            row[f"{k} mean"] = sum(v.values()) / len(v)
    res["cases"]["gk_decode b=32 L=256 kv=65-192 (numbers)"] = row
    show("gk_decode b=32 L=256", {k: v for k, v in row.items() if not isinstance(v, dict)})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "b13_phase_profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
