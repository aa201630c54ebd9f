"""Where a split-KV attention kernel's time goes: its source rebuilt with
parts cut out, and run at other KV chunk sizes, timed at its served shapes.
The cut builds give wrong results; they only time what is left.

Run from the repository root with one card:

    python3 torchmx_tpu_torch/tools/phase_profile.py --kernel b13|k4|k6|k7|b14|k5|k1|k2 [--root DIR] [--label NAME] [--chunks-only] [--cases TEXT]

K1 and K2 (``--kernel k1|k2``, ``profile_quantize``) are timed as they ship
(no cut builds) at the table's and the decode step's shapes, beside an
empty kernel's launch floor, K1 also as the KV cache write and K2 also
after and fused into the RMSNorm kernel.

``--root`` imports ``chip_smoke`` and ``torchmx_tpu_torch`` from another
checkout and cuts that checkout's source (for instance a parent commit
unpacked by ``git archive`` into a git-ignored directory): K6 before the
cluster kernel (chunks of ``k6_chunk(L)``) has cuts of its own.  Each patched copy is written under the package's git-ignored
``_build/``; the source itself is not touched.

Builds of B13 (``csrc/mx_mla.cu``), timed at ``chip_smoke.MLA_CASES`` and
at b=32 decodes over 2048 and 4096 positions, int8 seq latent:

* ``no_scores``: without the 36 score wgmmas of a tile;
* ``no_decode``: every position of a tile decoded as 0 (no code is read);
* ``data_path``: neither the dots nor the decode (copies, barriers, the
  softmax's instructions, the epilogue and the combine);
* ``stream``: ``data_path`` without the softmax (the copies and barriers);
* ``no_copies``: ``data_path`` with the producer arriving on each stage
  without copying (the consumers' side alone);
* ``no_tiles``: no tile at all (the CTA's launch, Q load, epilogue and
  combine).

Builds of K4's and K6's cluster kernel (``csrc/mx_attention_tile.cuh``, the
layout's source built with a patched copy of it), timed for K4 at G's decode
(fp8 and fp6, b=32 over 256 positions, kv_len 192, the numbers generate
passes), the engine's decode (b=32 over 1024, kv_len 0 .. 1024 ragged, fp8
and int8), one row at kv_len 700, b=4 over 8192 and 32768 (shares of 4096
in two chunks), and the int8 prefill and
chunk shapes of ``chip_smoke.check_int8_attention_kernels``; for K6 at
``K6_CASES``; each beside SDPA over the dequantized cache:

* ``no_dots``: no q.K^T or P.V mma (their fragments still loaded);
* ``no_decode``: the landed fills are not decoded;
* ``data_path``: neither;
* ``no_tiles``: no fill at all (the launch, the exchange and the combine);
* ``P=...``: the shipped kernel with another share (``attention_share``
  patched) wherever it divides JAX's tile or is whole tiles, gives at most 8
  CTAs a cluster and its scores fit.  ``--chunks-only`` times the shares
  alone.

Besides, K4 at G's and K6 at F's decode steps as ``generate`` calls them
(b=32 over 256 positions, fp8 seq / fp4 d-major, q_off and kv_len numbers,
kv_len 65 .. 192 at a stride of 16; ``generate_steps``), the mean a call
over the steps, each step timed flushed (``chip_smoke.Timer``), warm
(``warm_time``: 50 calls queued back to back, the cache in L2 from one to
the next) and cold (``cold_time``: as a host-bound step launches it, the
device idle and L2 holding other data, the kernel's own time from the
profiler); shipped, each cut and each share (or, for the chunked K6, chunk).
``--cases TEXT`` times only the cases whose label holds TEXT.

K4 before the cluster kernel (one CTA a 64-row tile, tiles of 64
positions, no split) is timed as it ships.  Builds of K6 with the KV split
(chunks and a ticket combine), timed at F's decode (fp4, b=32 over 256
positions, kv_len 192, as a tensor and as numbers), the engine's decode
(b=32 over 1024, kv_len 0 .. 1024 ragged, fp8 and int8), one row at kv_len
700, D's admission and chunk (int8, sq 384 and 128), the prefill of 32 x 64
(fp4) and the engine's whole admissions as it calls K6 (int8, numbers, sq 64
to 512, and 256 after a cached prefix of 128):

* ``no_dots``: no warp runs the two dots or the softmax;
* ``no_decode``: the landed tiles are not decoded (the consumers still wait
  for them and release them);
* ``data_path``: neither (copies, barriers, the epilogue and the combine);
* ``no_copies``: ``data_path`` with the ring's fills arriving without
  copying;
* ``no_tiles``: no tile at all (the CTA's launch, Q load, epilogue and
  combine);
* ``no_combine``: a tile with two live chunks or more writes its partials
  and stops (no ticket, no combine).

Builds of K7 (``csrc/mx_attention_int8dot.cu``), timed at ``chip_smoke``'s
three phase-2 cases (D's decode, b=32 over 1024 positions with kv_len 0 ..
1024 ragged; one row at kv_len 700; b=4 over 8192) and at D's shape with a
numeric kv_len, each beside SDPA over the dequantized cache, the plain
version and the byte bound:

* ``no_scores``: no transpose or dp4a of the scores (the K boxes still land
  and are released);
* ``no_pv``: no P.V mma (its fragments still loaded);
* ``no_softmax``: neither the softmax nor the requantization of p;
* ``data_path``: none of the three (copies, barriers, q's quantization, the
  epilogue and the combine);
* ``no_copies``: ``data_path`` with the ring's fills arriving without
  copying;
* ``no_tiles``: no box at all (the CTA's launch, q's quantization, the
  epilogue and the combine);
* ``no_combine``: a row with two live tiles or more writes its partials and
  stops;
* ``stages=4``, ``stages=8``: the shipped kernel with that ring depth at
  every tile (``ring_stages`` picks 8 at tiles of 1024 positions and more).

Builds of K7 before the redesign (a warp a tile of 128 positions, loads in
every lane, a second launch merging the splits): ``no_dots`` (no dp4a, no
P.V shuffle reductions), ``no_loads`` (the cache words replaced by
constants), ``neither``.

Builds of B14 (``csrc/mx_mla_int8dot.cu``), timed at ``chip_smoke.
MLA_INT8DOT_CASES`` (q quantized inside the call) and at GKD's decode steps
as it calls B14 (b=32 over 256 positions, q_off and kv_len numbers, kv_len
65 .. 192 at a stride of 16: ``gkd_decode``), each beside SDPA over the
dequantized latent, the plain version and the byte bound:

* ``no_scores``: no score k-block (no word loads, transposes or mma);
* ``no_pv``: no P.V mma (its fragments still loaded);
* ``no_softmax``: no pass of the softmax and requantization (the cluster's
  three barriers and its exchanges stay);
* ``data_path``: none of the three;
* ``no_copies``: ``data_path`` with the load groups' barriers arriving
  without copying;
* ``no_tiles``: no position visible to any CTA (launch, q's quantization,
  the cluster's barriers and exchanges, the epilogue and combine);
* ``no_combine``: a row with two live tiles or more writes its records and
  stops;
* ``P=128``, ``P=256``: the shipped kernel with that share a CTA at every
  tile where it gives at most 8 CTAs a cluster (``cuda_mla.b14_split``
  patched; P = 256 at L = 256 is one CTA a tile).

Builds of B14 before the redesign (a CTA of 16 heads walking its row's
prefix 32 positions at a time, synchronous loads, q quantized by a launch
of its own): ``no_dots`` (no mma), ``no_loads`` (the cache words replaced
by constants), ``neither``.

Builds of K5 (``csrc/mx_attention_chunkdot.cu``), timed at ``chip_smoke``'s
three phase-2 cases (the engine's decode, b=32 over 1024 positions with
kv_len 0 .. 1024 ragged; one row at kv_len 700; b=4 over 8192), at the
engine's shape with a numeric kv_len and at the ragged decode over 1152
positions (nine of JAX's tiles: shares of four), each beside SDPA over the
dequantized cache, the plain version and the byte bound:

* ``no_scores``: no conversion or mma of the scores (the K boxes still land
  and are released);
* ``no_pv``: no P.V mma (its fragments still loaded and converted);
* ``no_softmax``: no pass of p and l (the cluster's barriers and its
  exchanges stay);
* ``data_path``: none of the three;
* ``no_copies``: ``data_path`` with the ring's fills and the scale rows
  arriving without copying;
* ``skeleton``: ``no_copies`` without the P.V loop's fragments and the
  scores' epilogue (the ring's waits and releases alone);
* ``no_tiles``: no box at all (the launch, q's registers, the cluster's
  barriers and exchanges, the combine);
* ``stages=3`` .. ``stages=8``: the shipped kernel with that ring depth
  (the kernel's ``kStages`` is 2); ``min_ctas=2``, ``min_ctas=3``: its registers
  bounded for that many CTAs an SM (the kernel's bound is four);
* ``P=...``: the shipped kernel with that share a CTA (``k5_share``
  patched) wherever it divides JAX's tile or is whole tiles and gives at
  most 8 CTAs a cluster, and with each ring depth.  ``--chunks-only`` times the shares
  alone.

K5 before the redesign (warps walking tiles of 32 positions round-robin,
synchronous loads, a second launch merging the splits) is timed as it ships.

``S=...``: the shipped kernel at another chunk size (``mla_chunk`` or
``k6_chunk`` patched) where it gives at most 64 chunks, and for B13 at
generate's decode steps as it calls B13 (b=32 over 256 positions, q_off and
kv_len numbers, kv_len 65 .. 192 at a stride of 16: ``gk_decode``, the mean
a call and each step).  ``--chunks-only`` times the chunk sizes alone.

Times: ``chip_smoke.Timer`` (median of 20, L2 flushed, the device asleep
while the host enqueues).  Writes ``chiprun_out/phase_profile_<kernel>_<label>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys


def _guard(s: str, start: str, end: str, flag: str, other: str = "") -> str:
    """#ifndef flag around s[start .. end] (both included); ``other`` in its #else."""
    if start not in s:
        raise RuntimeError(f"the kernel source changed: {start!r} not found")
    a = s.index(start)
    b = s.index(end, a) + len(end)
    return s[:a] + f"#ifndef {flag}\n" + s[a:b] + ("#else\n" + other if other else "") + "\n#endif\n" + s[b:]


def _replace(s: str, old: str, new: str) -> str:
    if old not in s:
        raise RuntimeError(f"the kernel source changed: {old!r} not found")
    return s.replace(old, new)


# -- B13 --------------------------------------------------------------------------------------------

B13_CUTS = {"no_scores": ["NO_SCORES"], "no_decode": ["NO_DECODE"],
            "data_path": ["NO_SCORES", "NO_PV", "NO_DECODE"],
            "stream": ["NO_SCORES", "NO_PV", "NO_DECODE", "NO_SOFTMAX"],
            "no_copies": ["NO_SCORES", "NO_PV", "NO_DECODE", "NO_COPY"], "no_tiles": ["NO_TILES"]}


def b13_patched(src: str) -> str:
    """B13 with #ifndef guards around the score wgmmas (NO_SCORES), the P.lat
    wgmmas (NO_PV), the decode of a live position (NO_DECODE), the softmax
    (NO_SOFTMAX), the copies (NO_COPY) and the tile count (NO_TILES)."""
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
    s = _guard(s, "      mx::mbar_expect_tx(full, G::stage);", "kSP * G::rot_sc, full);\n      }\n", "NO_COPY",
               "      mx::mbar_arrive(full);")
    return _replace(s, "  const int nt = t_end > c0 ? (t_end - c0 + kT - 1) / kT : 0;",
                    "#ifdef NO_TILES\n  const int nt = 0;\n#else\n"
                    "  const int nt = t_end > c0 ? (t_end - c0 + kT - 1) / kT : 0;\n#endif")


# -- K6 ---------------------------------------------------------------------------------------------

K6_CUTS = {"no_dots": ["NO_DOTS"], "no_decode": ["NO_DECODE"], "data_path": ["NO_DOTS", "NO_DECODE"],
           "no_copies": ["NO_DOTS", "NO_DECODE", "NO_COPY"], "no_tiles": ["NO_TILES"], "no_combine": ["NO_COMBINE"]}


def k6_patched(src: str) -> str:
    """K6 with guards around a warp's dots and softmax (NO_DOTS), the decode
    of a landed tile (NO_DECODE), the producer's copies (NO_COPY), the tile
    count (NO_TILES) and the ticket and combine (NO_COMBINE)."""
    s = _replace(src, "      if (kt0 <= warp_qhi) {",
                 "#ifdef NO_DOTS\n      if (false) {\n#else\n      if (kt0 <= warp_qhi) {\n#endif")
    s = _replace(s, "    } else if (live_warp && kt0 <= warp_qhi) {",
                 "#ifdef NO_DOTS\n    } else if (false) {\n#else\n    } else if (live_warp && kt0 <= warp_qhi) {\n#endif")
    s = _guard(s, "#pragma unroll 2\n  for (int i = tid; i < 2 * kItems; i += kThreads) {",
               "      decode_segment<E>(&T[crow][seg * kSeg], cw, sw, live, false);\n    }\n  }\n", "NO_DECODE")
    s = _guard(s, "    mx::mbar_expect_tx(full, Geom::stage);",
               "    mx::tma_load_2d(st + Geom::o_vs, &tvs, full, pos, srow0);\n", "NO_COPY",
               "    mx::mbar_arrive(full);")
    s = _replace(s, "  const int nt = t_end > c0 ? (t_end - c0 + kL - 1) / kL : 0;",
                 "#ifdef NO_TILES\n  const int nt = 0;\n#else\n"
                 "  const int nt = t_end > c0 ? (t_end - c0 + kL - 1) / kL : 0;\n#endif")
    return _replace(s, "  __threadfence();\n  mx::named_barrier(1, kThreads);\n  int* last",
                    "#ifdef NO_COMBINE\n  return;\n#endif\n  __threadfence();\n  mx::named_barrier(1, kThreads);\n"
                    "  int* last")


# -- K7 ---------------------------------------------------------------------------------------------

K7_CUTS = {"no_scores": ["NO_SCORES"], "no_pv": ["NO_PV"], "no_softmax": ["NO_SOFTMAX"],
           "data_path": ["NO_SCORES", "NO_PV", "NO_SOFTMAX"], "no_copies": ["NO_SCORES", "NO_PV", "NO_SOFTMAX", "NO_COPY"],
           "no_tiles": ["NO_TILES"], "no_combine": ["NO_COMBINE"],
           "stages=4": ["K7_STAGES=4"], "stages=8": ["K7_STAGES=8"]}
K7_OLD_CUTS = {"no_dots": ["NO_DOTS"], "no_loads": ["NO_LOADS"], "neither": ["NO_DOTS", "NO_LOADS"]}
K7_OLD_MARK = "merge_splits_kernel"  # K7 before the redesign: a second launch merged the splits


def k7_patched(src: str) -> str:
    """K7 with guards around the scores' transposes and dp4a (NO_SCORES),
    the P.V mma (NO_PV: the loaded fragments still feed the accumulator),
    the softmax and requantization (NO_SOFTMAX), the producer's copies
    (NO_COPY: the barriers arrive without bytes), the tile's boxes
    (NO_TILES) and the ticket and combine (NO_COMBINE); ``-DK7_STAGES=n``
    sets the ring's slots at every tile (default ``ring_stages``)."""
    s = _replace(src, "  return lt >= 1024 && Smem(G, lt, 8).total + 1024 <= kSmemMax ? 8 : 4;",
                 "#ifdef K7_STAGES\n  return K7_STAGES;\n#endif\n"
                 "  return lt >= 1024 && Smem(G, lt, 8).total + 1024 <= kSmemMax ? 8 : 4;")
    s = _replace(s, "    for (int c = 0; c < kNc; ++c) {\n      int dot[4][G];",
                 "#ifdef NO_SCORES\n    for (int c = 0; c < 0; ++c) {\n#else\n    for (int c = 0; c < kNc; ++c) {\n#endif\n"
                 "      int dot[4][G];")
    s = _guard(s, "      mma_s8_acc(acc, a, bq);\n", "      mma_s8_acc(acc, a, bq);\n", "NO_PV",
               "      acc[0] ^= (int)(a[0] ^ a[1] ^ a[2] ^ a[3] ^ bq[0] ^ bq[1]);")
    s = _guard(s, "  // 3. Softmax and requantization over the tile",
               "      for (int c = 0; c < kNc; ++c) stat[2 * G + c * G + r] = mxc[c];\n    }\n  }\n", "NO_SOFTMAX")
    s = _guard(s, "        mx::mbar_expect_tx(full + 8 * slot, kSlot);",
               "t0 + box * kBox, crow);\n", "NO_COPY", "        mx::mbar_arrive(full + 8 * slot);")
    s = _guard(s, "          mx::mbar_expect_tx(scales, 2 * n_box * kNc * kBox);",
               "          }\n", "NO_COPY", "          mx::mbar_arrive(scales);")
    s = _replace(s, "  const int n_box = (nvis + kBox - 1) / kBox;",
                 "#ifdef NO_TILES\n  const int n_box = 0;\n#else\n  const int n_box = (nvis + kBox - 1) / kBox;\n#endif")
    return _replace(s, "  __threadfence();\n  mx::named_barrier(1, kConsumers);\n  int* last",
                    "#ifdef NO_COMBINE\n  return;\n#endif\n  __threadfence();\n  mx::named_barrier(1, kConsumers);\n"
                    "  int* last")


def k7_old_patched(src: str) -> str:
    """K7 before the redesign (one warp a 128-position tile, synchronous
    4-byte loads, the P.V sums reduced by shuffles, a second launch to merge
    the splits) with its dp4a and P.V reductions cut (NO_DOTS: the loaded
    words still feed the results) and its cache loads replaced by constants
    (NO_LOADS)."""
    s = _replace(src, "          for (int j = 0; j < 4; ++j) dot[j][r] = __dp4a((int)kw[gq][j], qv, dot[j][r]);",
                 "#ifdef NO_DOTS\n          for (int j = 0; j < 4; ++j) dot[j][r] ^= (int)kw[gq][j] ^ qv;\n#else\n"
                 "          for (int j = 0; j < 4; ++j) dot[j][r] = __dp4a((int)kw[gq][j], qv, dot[j][r]);\n#endif")
    s = _replace(s, "        for (int i = 0; i < 32; ++i) part_sum[i] = __dp4a(vw[i], (int)pq, 0);\n"
                    "        const int pv = warp_sum_32(part_sum, lane);",
                 "#ifdef NO_DOTS\n        int pv = (int)pq;\n        for (int i = 0; i < 32; ++i) pv ^= vw[i];\n#else\n"
                 "        for (int i = 0; i < 32; ++i) part_sum[i] = __dp4a(vw[i], (int)pq, 0);\n"
                 "        const int pv = warp_sum_32(part_sum, lane);\n#endif")
    for old, const in (("live ? *reinterpret_cast<const uint32_t*>(kd_h + (long long)(c * 32 + i) * L + p0) : 0u",
                        "(uint32_t)(p0 * 33 + i)"),
                       ("live ? *reinterpret_cast<const uint32_t*>(ks_h + (long long)c * L + p0) : 0u", "0x7B7B7B7Bu"),
                       ("live ? *reinterpret_cast<const uint32_t*>(vs_h + (long long)c * L + p0) : 0u", "0x7B7B7B7Bu"),
                       ("live ? *reinterpret_cast<const int*>(vd_h + (long long)(c * 32 + i) * L + p0) : 0",
                        "(int)(p0 * 31 + i)")):
        s = _replace(s, old, f"\n#ifdef NO_LOADS\n{const}\n#else\n{old}\n#endif\n")
    return s


# -- K5 ---------------------------------------------------------------------------------------------

K5_CUTS = {"no_scores": ["NO_SCORES"], "no_pv": ["NO_PV"], "no_softmax": ["NO_SOFTMAX"],
           "data_path": ["NO_SCORES", "NO_PV", "NO_SOFTMAX"], "no_copies": ["NO_SCORES", "NO_PV", "NO_SOFTMAX", "NO_COPY"],
           "skeleton": ["NO_SCORES", "NO_PV", "NO_SOFTMAX", "NO_COPY", "NO_PV_LOOP", "NO_EPILOGUE"],
           "no_tiles": ["NO_TILES"], "stages=3": ["K5_STAGES=3"],
           "stages=4": ["K5_STAGES=4"], "stages=8": ["K5_STAGES=8"], "min_ctas=2": ["K5_MIN_CTAS=2"],
           "min_ctas=3": ["K5_MIN_CTAS=3"]}
K5_OLD_MARK = "merge_splits_kernel"  # K5 before the redesign: a second launch merged the splits


def k5_patched(src: str) -> str:
    """K5 with guards around the scores' conversions and mma (NO_SCORES), the
    P.V mma (NO_PV: the converted fragments still feed the accumulator), the
    pass of p and l (NO_SOFTMAX), the producer's copies (NO_COPY: the
    barriers arrive without bytes) and the share's boxes (NO_TILES);
    ``-DK5_STAGES=n`` sets the ring's slots at every share."""
    s = _replace(src, "__launch_bounds__(kThreads, 4)",
                 "\n#ifdef K5_MIN_CTAS\n__launch_bounds__(kThreads, K5_MIN_CTAS)\n#else\n__launch_bounds__(kThreads, 4)\n#endif\n")
    s = _replace(s, "constexpr int kStages = 2;",
                 "#ifdef K5_STAGES\nconstexpr int kStages = K5_STAGES;\n#else\nconstexpr int kStages = 2;\n#endif")
    s = _replace(s, "      for (int c = 0; c < kNc; ++c) {\n        const int u = 2 * c + (t >> 1), o = 8 * (t & 1);",
                 "#ifdef NO_SCORES\n      for (int c = 0; c < 0; ++c) {\n#else\n      for (int c = 0; c < kNc; ++c) {\n#endif\n"
                 "        const int u = 2 * c + (t >> 1), o = 8 * (t & 1);")
    s = _guard(s, "    mma_bf16(acc[0], a, b0);\n", "    mma_bf16(acc[3], a, b3);\n", "NO_PV",
               "    acc[0][0] += __uint_as_float((a[0] ^ a[2] ^ b0[0] ^ b0[1] ^ b1[0] ^ b1[1] ^ b2[0] ^ b2[1] ^ b3[0] ^ b3[1])"
               " & 0x3FFFFFFFu);")
    s = _guard(s, "  // 3. p and l:", "    if (k == 0) lsh[r] = l;\n  }\n", "NO_SOFTMAX")
    s = _replace(s, "  auto pv_block = [&](uint32_t vt, int pos0, int blk, auto check) {\n",
                 "  auto pv_block = [&](uint32_t vt, int pos0, int blk, auto check) {\n#ifdef NO_PV_LOOP\n    return;\n#endif\n")
    s = _replace(s, "      for (int e = 0; e < 4; ++e) {\n        const int pos = p0 + g + 8 * (e >> 1), r = 2 * t + (e & 1);",
                 "#ifdef NO_EPILOGUE\n      for (int e = 0; e < 0; ++e) {\n#else\n      for (int e = 0; e < 4; ++e) {\n#endif\n"
                 "        const int pos = p0 + g + 8 * (e >> 1), r = 2 * t + (e & 1);")
    s = _guard(s, "        mx::mbar_expect_tx(full + 8 * slot, kSlot);", "(int)(row0 + (f % n_box) * kBox));\n", "NO_COPY",
               "        mx::mbar_arrive(full + 8 * slot);")
    s = _guard(s, "      mx::mbar_expect_tx(scales, 2 * sbytes);", "mx::bulk_load(sbase + lay.vs, vs + 4 * row0, sbytes, scales);\n",
               "NO_COPY", "      mx::mbar_arrive(scales);")
    return _replace(s, "  const int n_box = (nvis + kBox - 1) / kBox;",
                    "#ifdef NO_TILES\n  const int n_box = 0;\n#else\n  const int n_box = (nvis + kBox - 1) / kBox;\n#endif")


# -- B14 --------------------------------------------------------------------------------------------

B14_CUTS = {"no_scores": ["NO_SCORES"], "no_pv": ["NO_PV"], "no_softmax": ["NO_SOFTMAX"],
            "data_path": ["NO_SCORES", "NO_PV", "NO_SOFTMAX"],
            "no_copies": ["NO_SCORES", "NO_PV", "NO_SOFTMAX", "NO_COPY"],
            "no_tiles": ["NO_TILES"], "no_combine": ["NO_COMBINE"], "no_cluster": ["NO_CLUSTER"],
            "no_q": ["NO_Q"], "skeleton": ["NO_TILES", "NO_COMBINE", "NO_CLUSTER", "NO_Q"], "empty": ["EMPTY"]}
B14_OLD_CUTS = {"no_dots": ["NO_DOTS"], "no_loads": ["NO_LOADS"], "neither": ["NO_DOTS", "NO_LOADS"]}
B14_OLD_MARK = "LatD"  # B14 before the redesign: the tile kept twice, as read (LatD) and transposed


def b14_patched(src: str) -> str:
    """B14 with guards around the score k-blocks (NO_SCORES), the P.V mma
    (NO_PV: the loaded fragments still feed the accumulator), the softmax
    and requantization passes (NO_SOFTMAX: the cluster barriers stay), the
    copies (NO_COPY: the barriers arrive without bytes), the visible
    positions (NO_TILES), the ticket and combine (NO_COMBINE), the cluster
    (NO_CLUSTER: its barriers become the CTA's, every exchange reads the
    CTA's own shared memory), q's quantization (NO_Q), and all but the
    launch (EMPTY: every CTA returns at once)."""
    s = _replace(src, "      for (int kb = 0; kb < kR / 32; ++kb) score_block",
                 "      for (int kb = 0; kb < SCORE_KB(kR / 32); ++kb) score_block")
    s = _replace(s, "      for (int kb = 0; kb < kDr / 32; ++kb)\n",
                 "      for (int kb = 0; kb < SCORE_KB(kDr / 32); ++kb)\n")
    s = _replace(s, "        for (int nt = 0; nt < kNt; ++nt) mma_s8_acc(acc[mt][nt], a, b[nt]);",
                 "#ifdef NO_PV\n        for (int nt = 0; nt < kNt; ++nt)\n"
                 "          acc[mt][nt][0] ^= (int)(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[nt][0] ^ b[nt][1]);\n#else\n"
                 "        for (int nt = 0; nt < kNt; ++nt) mma_s8_acc(acc[mt][nt], a, b[nt]);\n#endif")
    s = s.replace("j < nvis; j += TPR)", "j < SOFTMAX_N(nvis); j += TPR)")
    s = _replace(s, "j < n_grp * kBox; j += 4 * TPR)", "j < SOFTMAX_N(n_grp * kBox); j += 4 * TPR)")
    s = _guard(s, "      mx::mbar_expect_tx(bar, kGroupBytes);", "rs + (long long)ib * L + pos, kBox, bar);\n",
               "NO_COPY", "      mx::mbar_arrive(bar);")
    s = _replace(s, "  const int nvis = min(max(kv_end - c0, 0), P);",
                 "#ifdef NO_TILES\n  const int nvis = 0;\n#else\n"
                 "  const int nvis = min(max(kv_end - c0, 0), P);\n#endif")
    s = _replace(s, "  __threadfence();\n  __syncthreads();\n  int* last",
                 "#ifdef NO_COMBINE\n  cluster_wait();\n  return;\n#endif\n  __threadfence();\n  __syncthreads();\n"
                 "  int* last")
    s = _replace(s, "__device__ __forceinline__ void cluster_arrive() {",
                 "#ifdef NO_CLUSTER\n__device__ __forceinline__ void cluster_arrive() {}\n"
                 "__device__ __forceinline__ void cluster_wait() { __syncthreads(); }\n"
                 "__device__ __forceinline__ void cluster_sync() { __syncthreads(); }\n"
                 "__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int) { return local; }\n#else\n"
                 "__device__ __forceinline__ void cluster_arrive() {")
    s = _replace(s, "__device__ __forceinline__ float ld_cluster_f32(",
                 "#endif\n__device__ __forceinline__ float ld_cluster_f32(")
    s = _replace(s, "  for (int i = 0; i < kQRows; ++i) {\n    const int r = warp + kWarps * i, head = hg * NR + r;",
                 "  for (int i = 0; i < (Q_ON ? kQRows : 0); ++i) {\n"
                 "    const int r = warp + kWarps * i, head = hg * NR + r;")
    s = _replace(s, "  if (tile >= n_live) return;", "  if (tile >= n_live || EMPTY_ON) return;")
    head = ("#ifdef NO_Q\n#define Q_ON 0\n#else\n#define Q_ON 1\n#endif\n"
            "#ifdef EMPTY\n#define EMPTY_ON 1\n#else\n#define EMPTY_ON 0\n#endif\n"
            "#ifdef NO_SCORES\n#define SCORE_KB(n) 0\n#else\n#define SCORE_KB(n) (n)\n#endif\n"
            "#ifdef NO_SOFTMAX\n#define SOFTMAX_N(n) 0\n#else\n#define SOFTMAX_N(n) (n)\n#endif\n")
    return head + s


def b14_old_patched(src: str) -> str:
    """B14 before the redesign with its three mma cut (NO_DOTS: the loaded
    fragments still feed the results) and its cache word loads replaced by
    constants (NO_LOADS)."""
    s = src
    for call, frag in (("mx::mma_s8_16832(c, qa[kk], b);", "qa[kk][0]"), ("mx::mma_s8_16832(c, qra, b);", "qra[0]"),
                       ("mx::mma_s8_16832(c, pa, b);", "pa[0]")):
        s = _replace(s, call, f"\n#ifdef NO_DOTS\nc[0] = c[1] = c[2] = c[3] = (int)({frag} ^ b[0] ^ b[1]);\n#else\n"
                              f"{call}\n#endif\n")
    old = "uint32_t v = *reinterpret_cast<const uint32_t*>(src + (long long)i * L);"
    return _replace(s, old, f"\n#ifdef NO_LOADS\nuint32_t v = (uint32_t)(c * 33 + i);\n#else\n{old}\n#endif\n")


# -- K4 and K6: the cluster kernel -----------------------------------------------------------------

TILE_HEADER = "mx_attention_tile.cuh"
TILE_CUTS = {"no_dots": ["NO_DOTS"], "no_decode": ["NO_DECODE"], "data_path": ["NO_DOTS", "NO_DECODE"],
             "no_tiles": ["NO_TILES"]}


def tile_source(csrc, src_name: str) -> str:
    """The layout's source with a patched copy of the cluster kernel in place
    of its include: #ifdef guards around the two dots' mma (NO_DOTS), the
    decode of a fill (NO_DECODE) and the share's fills (NO_TILES)."""
    h = (csrc / TILE_HEADER).read_text()
    for mma in ("mma_bf16_16816(s, a, b);", "mma_bf16_16816(acc[jn], a, b);"):
        h = _replace(h, mma, f"\n#ifndef NO_DOTS\n{mma}\n#endif\n")
    h = _replace(h, "  if constexpr (Lay == kSeq) {  // st: [position][d] codes",
                 "#ifdef NO_DECODE\n  return;\n#endif\n  if constexpr (Lay == kSeq) {  // st: [position][d] codes")
    h = _replace(h, "  const int nt = (nvis + kSub - 1) / kSub;",
                 "#ifdef NO_TILES\n  const int nt = 0;\n#else\n  const int nt = (nvis + kSub - 1) / kSub;\n#endif")
    return _replace((csrc / f"{src_name}.cu").read_text(), f'#include "{TILE_HEADER}"', h)


def at_shares(ca, row: dict, L: int, fn):
    """fn() timed at every share the cluster kernel takes for L (a multiple
    of 64 dividing JAX's tile or whole tiles, at most 8 a cache and
    ``ATTN_MAX_SHARE`` positions; past ``ATTN_WIDE_SHARE`` in 16-row tiles)."""
    share_of, lt = ca.attention_share, ca.attention_tile(L)
    try:
        for P in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
            if (lt % P == 0 or P % lt == 0) and -(-L // P) <= ca.ATTN_MAX_SHARES and P <= ca.ATTN_MAX_SHARE:
                ca.attention_share = lambda L_, P=P: P
                row[f"P={P}"] = fn()
    finally:
        ca.attention_share = share_of


K4_CASES = [("G decode b=32 L=256 kv=192 (numbers)", 32, 256, 1, [192] * 32, False, "float8_e4m3", True),
            ("G decode b=32 L=256 kv=192 (numbers)", 32, 256, 1, [192] * 32, False, "float6_e3m2", True),
            ("decode b=32 L=256 kv=192", 32, 256, 1, [192] * 32, False, "float8_e4m3", False),
            ("decode b=32 L=1024 ragged", 32, 1024, 1, [0] + [1 + (1023 * i) // 30 for i in range(31)], True,
             "float8_e4m3", False),
            ("decode b=32 L=1024 ragged", 32, 1024, 1, [0] + [1 + (1023 * i) // 30 for i in range(31)], True,
             "int8", False),
            ("decode b=1 L=1024 kv=700", 1, 1024, 1, [700], True, "float8_e4m3", False),
            ("decode b=4 L=8192 kv=8192", 4, 8192, 1, [8192] * 4, True, "float8_e4m3", False),
            ("decode b=4 L=32768 kv=32768", 4, 32768, 1, [32768] * 4, True, "float8_e4m3", False),
            ("whole b=1 L=1024 sq=384", 1, 1024, 384, [384], False, "int8", False),
            ("chunk b=1 L=1024 sq=128 q_off=256", 1, 1024, 128, [384], False, "int8", False),
            ("remainder b=1 L=1024 sq=64 q_off=128", 1, 1024, 64, [192], False, "int8", False),
            ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32, False, "int8", False)]


def warm_time(fn, reps: int = 50) -> float:
    """Mean device ms of one of ``reps`` calls queued back to back while the
    device sleeps (about 10 ms, so the host has enqueued them all before it
    wakes): no flush between them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_OTHER: list = []  # a buffer larger than L2, read before each cold call


def cold_time(fn, reps: int = 20) -> float:
    """Mean device ms of fn's attention kernel launched as a host-bound
    decode step launches it: L2 refilled with other data (96 MiB read) and
    the device idle for about 0.2 ms before each call; from the profiler's
    kernel records (the kernel alone, not its launch)."""
    import time

    import torch

    if not _OTHER:
        _OTHER.append(torch.ones(24 * 2**20, dtype=torch.float32, device="cuda"))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _OTHER[0].sum()
            torch.cuda.synchronize()
            time.sleep(2e-4)
            fn()
        torch.cuda.synchronize()
    d = [e.time_range.end - e.time_range.start for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and "attention" in e.name]
    return sum(d) / len(d) / 1e3


def generate_steps(cs, ca, cuda_lib, dev, gen, timer, layout: str, src_name: str, libs: dict, tile: bool) -> dict:
    """K4 (fp8 seq: G) or K6 (fp4 d-major: F) at generate's decode steps
    (``GK_KV``, numbers), the mean ms a call flushed and warm: shipped, each
    cut, each share (the cluster kernel) or chunk (K6 before it)."""
    elem = "float8_e4m3" if layout == "seq" else "float4_e2m1"
    seq = cs._attn_case(dev, gen, 32, 32, 8, 128, 256, 1, [256] * 32, elem)
    args = seq if layout == "seq" else cs._to_dmajor(seq)
    kernel = ca.mx_cached_attention if layout == "seq" else ca.mx_cached_attention_dmajor

    def steps():
        calls = [lambda kv=kv: kernel(*args[:5], kv - 1, kv, *args[7:]) for kv in GK_KV]
        return dict(flushed=sum(timer(c) for c in calls) / len(calls),
                    warm=sum(warm_time(c) for c in calls) / len(calls),
                    cold=sum(cold_time(c) for c in calls) / len(calls))

    row = dict(shipped=steps())
    shipped = cuda_lib.lib(src_name)
    try:
        for name, lib in libs.items():
            cuda_lib._libs[src_name] = lib
            row[name] = steps()
    finally:
        cuda_lib._libs[src_name] = shipped
    if tile:
        row["shipped_share"] = ca.attention_share(256)
        at_shares(ca, row, 256, steps)
    elif hasattr(ca, "k6_chunk") and layout == "dmajor":
        row["shipped_chunk"] = ca.k6_chunk(256)
        at_chunks(ca, "k6_chunk", row, 256, steps, step=64)
    return row


def profile_tile(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show, layout: str, only: str = "") -> dict:
    """K4 (``layout="seq"``) or K6 as the checkout ships it, beside SDPA; with
    the cluster kernel also its cut builds and its shares."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_attention as ca

    src_name = "mx_attention" if layout == "seq" else "mx_attention_dmajor"
    source = (cuda_lib.CSRC_DIR / f"{src_name}.cu").read_text()
    tile = TILE_HEADER in source
    libs = {}
    if not chunks_only:
        if tile:
            libs = build_cuts(cuda_lib, src_name, tile_source(cuda_lib.CSRC_DIR, src_name), TILE_CUTS)
        elif layout == "dmajor":  # K6 with chunks and a ticket combine
            libs = build_cuts(cuda_lib, src_name, k6_patched(source), K6_CUTS)
    kernel = ca.mx_cached_attention if layout == "seq" else ca.mx_cached_attention_dmajor
    cases = {}
    for label, b, L, sq, kv, fresh, elem, numbers in K4_CASES if layout == "seq" else K6_CASES:
        if only not in label:
            continue
        seq = cs._attn_case(dev, gen, b, 32, 8, 128, L, sq, kv, elem, never_written=fresh)
        args = seq if layout == "seq" else cs._to_dmajor(seq)
        if numbers:
            args = (*args[:5], kv[0] - sq, kv[0], *args[7:])
        fn = lambda: kernel(*args)  # noqa: E731
        row = time_cuts(cuda_lib, src_name, libs, timer, fn)
        k, v, mask = cs._sdpa_inputs(seq)
        row["sdpa"] = timer(lambda: F.scaled_dot_product_attention(seq[0], k, v, attn_mask=mask, scale=seq[7],
                                                                   enable_gqa=True))
        del k, v, mask
        if tile:
            row["shipped_share"] = ca.attention_share(L)
            at_shares(ca, row, L, lambda: timer(fn))
        elif hasattr(ca, "k6_chunk") and layout == "dmajor":
            row["shipped_chunk"] = ca.k6_chunk(L)
            at_chunks(ca, "k6_chunk", row, L, lambda: timer(fn), step=64)
        cases[f"{label} {elem}"] = row
        show(f"{label} {elem}", row)
        del args, seq
    label = "G decode steps" if layout == "seq" else "F decode steps"
    if only in label:
        cases[label] = generate_steps(cs, ca, cuda_lib, dev, gen, timer, layout, src_name, libs, tile)
        show(label, cases[label])
    return cases


# -- the runs ---------------------------------------------------------------------------------------


def build_cuts(cuda_lib, src_name: str, source: str, cuts: dict) -> dict:
    """Each cut of ``source`` built at once (one nvcc each), bound as ``src_name``."""
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_path = cuda_lib.BUILD_DIR / f"phase_profile_{src_name}_{os.getpid()}.cu"
    src_path.write_text(source)
    procs = {}
    for name, flags in cuts.items():
        out = cuda_lib.BUILD_DIR / f"lib{src_name}-{name}-{os.getpid()}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *(f"-D{f}" for f in flags), "-I", str(cuda_lib.CSRC_DIR),
               "-o", str(out), str(src_path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build {name} failed:\n{log.decode(errors='replace')}")
        libs[name] = cuda_lib._bind(ctypes.CDLL(str(out)), src_name)
    return libs


def time_cuts(cuda_lib, src_name: str, libs: dict, timer, fn) -> dict:
    """fn() timed with the shipped library and with each cut's."""
    row = dict(shipped=timer(fn))
    shipped = cuda_lib.lib(src_name)
    try:
        for name, lib in libs.items():
            cuda_lib._libs[src_name] = lib
            row[name] = timer(fn)
    finally:
        cuda_lib._libs[src_name] = shipped
    return row


def at_chunks(module, attr: str, row: dict, L: int, fn, chunks=(32, 64, 128, 256, 512, 1024), step: int = 32):
    """fn() timed at every chunk size (a multiple of ``step``) that gives at most 64 chunks."""
    chunk_of = getattr(module, attr)
    try:
        for S in chunks:
            if S % step == 0 and S <= L and -(-L // S) <= 64:
                setattr(module, attr, lambda L_, S=S: S)
                row[f"S={S}"] = fn()
    finally:
        setattr(module, attr, chunk_of)


GK_KV = (65, 81, 97, 113, 129, 145, 161, 177, 192)  # generate's decode: prompt 64 + 128 tokens, L = 256


def profile_b13(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show) -> dict:
    from torchmx_tpu_torch.ops import cuda_mla

    source = (cuda_lib.CSRC_DIR / "mx_mla.cu").read_text()
    libs = {} if chunks_only else build_cuts(cuda_lib, "mx_mla", b13_patched(source), B13_CUTS)
    cases = {}
    wide = [(f"decode b=32 L={L} ragged", 32, 16, L, 1, [1 + round(i * (L - 1) / 31) for i in range(32)])
            for L in (2048, 4096)]
    for label, b, n, L, sq, kv in cs.MLA_CASES + wide:
        c = cs._mla_case(dev, gen, b, n, L, sq, kv, "int8")
        args = cs._mla_args(c)
        fn = lambda: cuda_mla.mx_mla_attention(*args)  # noqa: E731
        row = time_cuts(cuda_lib, "mx_mla", libs, timer, fn)
        row["shipped_chunk"] = cuda_mla.mla_chunk(L)
        at_chunks(cuda_mla, "mla_chunk", row, L, lambda: timer(fn))
        cases[label] = row
        show(label, row)
        del c, args
    c = cs._mla_case(dev, gen, 32, 16, 256, 1, [256] * 32, "int8")
    args = cs._mla_args(c)

    def gk_steps():  # {kv_len: ms} of generate's calls, q_off and kv_len numbers
        return {kv: timer(lambda kv=kv: cuda_mla.mx_mla_attention(*args[:6], kv - 1, kv, *args[8:])) for kv in GK_KV}

    row = dict(shipped_chunk=cuda_mla.mla_chunk(256), shipped=gk_steps())
    at_chunks(cuda_mla, "mla_chunk", row, 256, gk_steps)
    for k, v in list(row.items()):
        if isinstance(v, dict):
            row[f"{k} mean"] = sum(v.values()) / len(v)
    cases["gk_decode b=32 L=256 kv=65-192 (numbers)"] = row
    show("gk_decode b=32 L=256", {k: v for k, v in row.items() if not isinstance(v, dict)})
    return cases


RAGGED = [0] + [1 + (1023 * i) // 30 for i in range(31)]  # chip_smoke's engine decode: kv_len 0 .. 1024
# (label, b, L, sq, kv_len of each row, never written past the prefix, format, kv_len as numbers)
K6_CASES = [("F decode b=32 L=256 kv=192", 32, 256, 1, [192] * 32, False, "float4_e2m1", False),
            ("F decode b=32 L=256 kv=192 (numbers)", 32, 256, 1, [192] * 32, False, "float4_e2m1", True),
            ("decode b=32 L=1024 ragged", 32, 1024, 1, RAGGED, True, "float8_e4m3", False),
            ("decode b=32 L=1024 ragged", 32, 1024, 1, RAGGED, True, "int8", False),
            ("decode b=1 L=1024 kv=700", 1, 1024, 1, [700], True, "float8_e4m3", False),
            ("whole b=1 L=1024 sq=384", 1, 1024, 384, [384], False, "int8", False),
            ("chunk b=1 L=1024 sq=128 q_off=256", 1, 1024, 128, [384], False, "int8", False),
            ("prefill b=32 L=256 sq=64", 32, 256, 64, [64] * 32, False, "float4_e2m1", False),
            # the engine's whole admissions over its 1024-position slot, as it calls K6 (numbers)
            ("admission b=1 L=1024 sq=64", 1, 1024, 64, [64], False, "int8", True),
            ("admission b=1 L=1024 sq=128", 1, 1024, 128, [128], False, "int8", True),
            ("admission b=1 L=1024 sq=256", 1, 1024, 256, [256], False, "int8", True),
            ("admission b=1 L=1024 sq=512", 1, 1024, 512, [512], False, "int8", True),
            ("admission b=1 L=1024 sq=256 after a prefix of 128", 1, 1024, 256, [384], False, "int8", True)]


K7_CASES = [("decode b=32 L=1024 ragged", 32, 1024, RAGGED, False),  # D's decode shape
            ("decode b=1 L=1024 kv=700", 1, 1024, [700], False),
            ("decode b=4 L=8192 kv=8192", 4, 8192, [8192] * 4, False),
            ("decode b=32 L=1024 ragged (numbers: kv 1024)", 32, 1024, [1024] * 32, True)]


def profile_k7(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show) -> dict:
    """K7 at ``chip_smoke``'s three phase-2 cases (and D's shape with a
    numeric kv_len): the shipped kernel with its q quantization, SDPA over the
    dequantized cache, the plain version, the byte bound, and each cut."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_attention as ca

    source = (cuda_lib.CSRC_DIR / "mx_attention_int8dot.cu").read_text()
    old = K7_OLD_MARK in source
    libs = {} if chunks_only else build_cuts(cuda_lib, "mx_attention_int8dot",
                                             k7_old_patched(source) if old else k7_patched(source),
                                             K7_OLD_CUTS if old else K7_CUTS)
    cases = {}
    for label, b, L, kv, numbers in K7_CASES:
        seq = cs._attn_case(dev, gen, b, 32, 8, 128, L, 1, kv, "int8", never_written=True)
        args = cs._to_dmajor(seq)[:8]
        if numbers:
            args = (*args[:5], kv[0] - 1, kv[0], args[7])
        fn = lambda: ca.mx_cached_attention_int8dot(*args)  # noqa: E731
        row = time_cuts(cuda_lib, "mx_attention_int8dot", libs, timer, fn)
        k, v, mask = cs._sdpa_inputs(seq)
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            seq[0], k, v, attn_mask=mask, scale=seq[7], enable_gqa=True))
        row["plain_ms"] = timer(lambda: ca.mx_cached_attention_int8dot_plain(*args), reps=5)
        row["bound_ms"], row["bound_by"] = cs.bound(*cs._attn_work(seq))
        cases[label] = row
        show(label, row)
        del seq, args, k, v, mask
    return cases


# K5's: K7's and the decode over 1152 positions (nine tiles of 128: a CTA takes four).
K5_CASES = K7_CASES + [("decode b=32 L=1152 ragged", 32, 1152, [0] + [1 + (1151 * i) // 30 for i in range(31)], False)]


def profile_k5(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show) -> dict:
    """K5 at ``chip_smoke``'s three phase-2 cases, the engine's shape with a
    numeric kv_len and the decode over 1152 positions: the shipped kernel, SDPA over the dequantized
    cache, the plain version, the byte bound, each cut and each share a CTA
    (before the redesign: the shipped kernel alone)."""
    import torch.nn.functional as F

    from torchmx_tpu_torch.ops import cuda_attention as ca

    source = (cuda_lib.CSRC_DIR / "mx_attention_chunkdot.cu").read_text()
    old = K5_OLD_MARK in source
    libs = {} if chunks_only or old else build_cuts(cuda_lib, "mx_attention_chunkdot", k5_patched(source), K5_CUTS)
    share = getattr(ca, "k5_share", None)

    def at_shares(row, L, fn):  # fn() timed at each share that divides JAX's tile, at most 8 CTAs a cluster
        if share is None:
            return
        row["shipped_P"] = share(L)
        shipped = cuda_lib.lib("mx_attention_chunkdot")
        try:
            lt, most = ca.attention_tile(L), getattr(ca, "K5_MAX_SHARE", None)  # None: no share of several tiles
            for P in (128, 256, 512, 1024, 2048, 4096):
                if (lt % P == 0 or (most and P % lt == 0 and P <= most)) and -(-L // P) <= ca.K5_MAX_SHARES:
                    ca.k5_share = lambda L_, P=P: P
                    row[f"P={P}"] = fn()
                    for name in ("stages=3", "stages=4", "min_ctas=2", "min_ctas=3"):  # each ring depth, CTAs an SM
                        if name in libs:
                            cuda_lib._libs["mx_attention_chunkdot"] = libs[name]
                            row[f"P={P} {name}"] = fn()
                            cuda_lib._libs["mx_attention_chunkdot"] = shipped
        finally:
            ca.k5_share = share
            cuda_lib._libs["mx_attention_chunkdot"] = shipped

    cases = {}
    for label, b, L, kv, numbers in K5_CASES:
        if L // ca.attention_tile(L) > ca.K5_MAX_SHARES and not hasattr(ca, "K5_MAX_SHARE"):
            continue  # a K5 before shares of several tiles: K4 serves such a cache
        seq = cs._attn_case(dev, gen, b, 32, 8, 128, L, 1, kv, "int8", never_written=True)
        args = seq[:8]
        if numbers:
            args = (*args[:5], kv[0] - 1, kv[0], args[7])
        fn = lambda: ca.mx_cached_attention_chunkdot(*args)  # noqa: E731
        row = time_cuts(cuda_lib, "mx_attention_chunkdot", libs, timer, fn)
        at_shares(row, L, lambda: timer(fn))
        k, v, mask = cs._sdpa_inputs(seq)
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            seq[0], k, v, attn_mask=mask, scale=seq[7], enable_gqa=True))
        row["plain_ms"] = timer(lambda: ca.mx_cached_attention_chunkdot_plain(*args), reps=5)
        row["bound_ms"], row["bound_by"] = cs.bound(*cs._attn_work(seq))
        cases[label] = row
        show(label, row)
        del seq, args, k, v, mask
    return cases


def profile_b14(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show) -> dict:
    """B14 at ``chip_smoke.MLA_INT8DOT_CASES`` and at GKD's decode steps: the
    shipped kernel (q quantized inside the call), SDPA over the dequantized
    latent, the plain version, the byte bound, each cut and, for the
    redesigned kernel, each share a CTA (``--chunks-only``: the shares alone)."""
    from torchmx_tpu_torch.ops import cuda_mla

    source = (cuda_lib.CSRC_DIR / "mx_mla_int8dot.cu").read_text()
    old = B14_OLD_MARK in source
    libs = {} if chunks_only else build_cuts(cuda_lib, "mx_mla_int8dot",
                                             b14_old_patched(source) if old else b14_patched(source),
                                             B14_OLD_CUTS if old else B14_CUTS)
    split = getattr(cuda_mla, "b14_split", None)

    def at_shares(row, L, fn):  # fn() timed at each share a CTA that gives at most 8 CTAs a tile
        if split is None:
            return
        lt, shipped = split(L)
        row["shipped_P"] = shipped
        try:
            for P in (128, 256):
                if lt % P == 0 and lt // P <= 8:
                    cuda_mla.b14_split = lambda L_, P=P: (cuda_mla._pick_lt(L_), P)
                    row[f"P={P}"] = fn()
        finally:
            cuda_mla.b14_split = split

    def args_of(c):
        return (c["q_lat"], c["q_rot"], *c["cache"].buffers, c["q_off"], c["kv_len"], c["sm"])

    cases = {}
    for label, b, n, L, sq, kv in cs.MLA_INT8DOT_CASES:
        c = cs._mla_case(dev, gen, b, n, L, sq, kv, "int8", layout="dmajor")
        args = args_of(c)
        fn = lambda: cuda_mla.mx_mla_attention_int8dot(*args)  # noqa: E731
        row = time_cuts(cuda_lib, "mx_mla_int8dot", libs, timer, fn)
        at_shares(row, L, lambda: timer(fn))
        lib_fn, row["library_backend"] = cs._mla_library(c)
        row["library_ms"] = timer(lib_fn, reps=5)
        row["plain_ms"] = timer(lambda: cuda_mla.mx_mla_attention_int8dot_plain(*args), reps=3)
        row["bound_ms"], row["bound_by"] = cs.bound(*cs._mla_work(c), cs.INT8_OPS)
        cases[label] = row
        show(label, row)
        del c, args
    c = cs._mla_case(dev, gen, 32, 16, 256, 1, [256] * 32, "int8", layout="dmajor")
    args = args_of(c)

    def gkd_steps():  # {kv_len: ms} of generate's calls, q_off and kv_len numbers
        return {kv: timer(lambda kv=kv: cuda_mla.mx_mla_attention_int8dot(*args[:6], kv - 1, kv, args[8]))
                for kv in GK_KV}

    row = dict(shipped=gkd_steps())
    shipped = cuda_lib.lib("mx_mla_int8dot")
    try:
        for name, lib in libs.items():
            cuda_lib._libs["mx_mla_int8dot"] = lib
            row[name] = gkd_steps()
    finally:
        cuda_lib._libs["mx_mla_int8dot"] = shipped
    at_shares(row, 256, gkd_steps)
    for k, v in list(row.items()):
        if isinstance(v, dict):
            row[f"{k} mean"] = sum(v.values()) / len(v)
    cases["gkd_decode b=32 L=256 kv=65-192 (numbers)"] = row
    show("gkd_decode b=32 L=256", {k: v for k, v in row.items() if not isinstance(v, dict)})
    return cases


def profile_k4(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show, only: str = "") -> dict:
    return profile_tile(cs, cuda_lib, dev, timer, gen, chunks_only, show, "seq", only)


def profile_k6(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show, only: str = "") -> dict:
    return profile_tile(cs, cuda_lib, dev, timer, gen, chunks_only, show, "dmajor", only)


def profile_quantize(cs, cuda_lib, dev, timer, gen, chunks_only: bool, show, kernel: str = "k1") -> dict:
    """K1 (``kernel="k1"``) or K2 (``"k2"``) at the table's and the decode
    step's shapes: flushed (``chip_smoke.Timer``), warm (``warm_time``), the
    plain version and the byte bound beside an empty kernel
    (``torch.cuda._sleep(0)``) under the same timers, the launch floor.  K1
    also as the cache write (b=32, one token a row at per-row positions, L =
    1024; device ms and host us a call, as ``chip_smoke.check_cache_write``);
    K2 also after the RMSNorm kernel, and fused into it where the checkout
    has the fused mode."""
    import inspect
    import time

    import torch

    from torchmx_tpu_torch.models.llama import MXLayerKVCache
    from torchmx_tpu_torch.ops import cuda_norm
    from torchmx_tpu_torch.ops import cuda_quantize as cq

    def bf16(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = {"empty kernel": dict(ms=timer(lambda: torch.cuda._sleep(0)), warm_ms=warm_time(lambda: torch.cuda._sleep(0)))}
    show("empty kernel", rows["empty kernel"])

    def case(label, fn, plain, bytes_):
        row = dict(ms=timer(fn), warm_ms=warm_time(fn), plain_ms=timer(plain, reps=5),
                   bound_ms=bytes_ / cs.HBM_BYTES_PER_S * 1e3)
        rows[label] = row
        show(label, row)

    if kernel == "k1":
        for elem, shape in (("float8_e4m3", (32, 8, 64, 128)), ("int8", (32, 8, 1, 128)), ("int8", (1, 8, 1, 128)),
                            ("float4_e2m1", (4096, 4096))):
            x = bf16(*shape)
            n = x.numel()
            case(f"{elem} {shape}", lambda: cq.mx_quantize(x, elem), lambda: cq.mx_quantize_plain(x, elem),
                 2 * n + (n / 2 if elem == "float4_e2m1" else n) + n / 32)
        for M in (1, 32, 256):
            x = bf16(M, 4096)
            n = x.numel()
            case(f"int8 dot order ({M}, 4096)", lambda: cq.mx_quantize_dot(x, "int8"),
                 lambda: cq.mx_quantize_dot_plain(x, "int8"), 2 * n + n + 4 * n / 32)
        b, kv, L, d = 32, 8, 1024, 128
        k1, v1 = bf16(b, kv, 1, d), bf16(b, kv, 1, d)
        pos = torch.randint(64, L, (b,), generator=gen, device=dev).int()
        for elem, layout in (("int8", "seq"), ("int8", "dmajor"), ("float4_e2m1", "dmajor"), ("float8_e4m3", "seq")):
            cache = MXLayerKVCache.create(b, kv, L, d, elem, device=dev, layout=layout)
            cache.write(k1, v1, pos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                cache.write(k1, v1, pos)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            n = k1.numel()
            row = dict(ms=timer(lambda: cache.write(k1, v1, pos)), warm_ms=warm_time(lambda: cache.write(k1, v1, pos)),
                       host_us=host_us, bound_ms=2 * (2 * n + n + n / 32) / cs.HBM_BYTES_PER_S * 1e3)
            rows[f"cache write {elem} {layout}"] = row
            show(f"cache write {elem} {layout}", row)
    else:
        w = (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(torch.bfloat16)
        fused = "act" in inspect.signature(cuda_norm.rms_norm).parameters
        for M in (2048, 256, 32, 1):
            x = bf16(M, 4096)
            n = x.numel()
            case(f"fp8 ({M}, 4096)", lambda: cq.mx_fake_quantize_kernel(x, "float8_e4m3"),
                 lambda: cq.mx_fake_quantize_plain(x, "float8_e4m3"), 4 * n)
            two = (lambda: cq.mx_fake_quantize_kernel(cuda_norm.rms_norm(x, w, 1e-5), "float8_e4m3"))
            row = dict(norm_then_k2_ms=timer(two), norm_then_k2_warm_ms=warm_time(two),
                       norm_ms=timer(lambda: cuda_norm.rms_norm(x, w, 1e-5)))
            if fused:
                one = (lambda: cuda_norm.rms_norm(x, w, 1e-5, "float8_e4m3"))
                row.update(fused_ms=timer(one), fused_warm_ms=warm_time(one))
            rows[f"RMSNorm and K2 fp8 ({M}, 4096)"] = row
            show(f"RMSNorm and K2 fp8 ({M}, 4096)", row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("b13", "k4", "k6", "k7", "b14", "k5", "k1", "k2"), required=True)
    ap.add_argument("--root", default=".", help="checkout to import chip_smoke and the package from")
    ap.add_argument("--label", default="change")
    ap.add_argument("--chunks-only", action="store_true", help="time the chunk sizes alone (no cut builds)")
    ap.add_argument("--cases", default="", help="k4 / k6: time only the cases whose label holds this text")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("phase_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torchmx_tpu_torch.ops import cuda_lib

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not from {root}")
    cuda_lib.build_all()
    dev, card = torch.device("cuda"), cs.card_line()
    timer, gen = cs.Timer(dev), torch.Generator(dev).manual_seed(1)

    def show(label, row):
        print(f"[{args.label}] {args.kernel} {label}: " + json.dumps(
            {k: round(v, 4) if isinstance(v, float) else v for k, v in row.items()}) + f" ms [{card}]", flush=True)

    profile = dict(b13=profile_b13, k4=profile_k4, k6=profile_k6, k7=profile_k7, b14=profile_b14,
                   k5=profile_k5, k1=profile_quantize, k2=profile_quantize)[args.kernel]
    extra = dict(only=args.cases) if args.kernel in ("k4", "k6") else {}
    if args.kernel in ("k1", "k2"):
        extra = dict(kernel=args.kernel)
    res = dict(card=card, label=args.label, root=root,
               cases=profile(cs, cuda_lib, dev, timer, gen, args.chunks_only, show, **extra))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"phase_profile_{args.kernel}_{args.label}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
