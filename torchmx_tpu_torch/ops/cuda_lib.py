"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The first
use builds every source at once, one ``nvcc`` process each, into
``torchmx_tpu_torch/_build/`` (git-ignored); a library whose source, headers
and flags are unchanged is reused (its file name carries their hash).  Delete
that directory to force a rebuild.

The kernels are compiled without fast math and with ``-ftz=false``: the
quantizers' bit-exactness relies on fp32 subnormal operands being honoured.

A build or launch failure raises; nothing falls back to the plain path.
Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("mx_quantize", "mx_matmul", "mx_attention", "mx_attention_chunkdot",
           "mx_attention_dmajor", "mx_attention_int8dot", "mx_matmul_1byte", "mx_matmul_fp6q",
           "mx_matmul_int8dot", "mx_rmsnorm", "mx_grouped_matmul", "mx_router", "mx_mla", "mx_mla_int8dot")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-ftz=false", "-prec-div=true", "-prec-sqrt=true", "-lineinfo",
)

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# C signature of every entry point: (argtypes, restype is int = cudaError_t)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "mx_quantize": {
        # x, scale, codes, rows, K, elem_code, the card's SM count, stream
        "mx_quantize_launch": (_P, _P, _P, _L, _I, _I, _I, _P),
        # x, pxT (f32 scale factors), codes, rows, K, Mp (pxT's width), elem_code, SMs, stream: B9's dot order
        "mx_quantize_dot_launch": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
        # x, out, rows, K, elem_code, SMs, stream
        "mx_fake_quantize_launch": (_P, _P, _L, _I, _I, _I, _P),
        # x, out, rows, K, Kp (the planes' width), elem_code (-1: copy), SMs, stream
        "mx_fake_quantize_planes_launch": (_P, _P, _L, _I, _I, _I, _I, _P),
        # k, its strides of (b, hkv, s), v, its strides, the cache's k codes, k scales, v codes, v scales,
        # pos (null: the number that follows), pos number, b, hkv, s, d, L, elem_code, dmajor, SMs, stream
        "mx_cache_write_launch": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _P),
        # x1, x2, codes1, scale1, codes2, scale2, pos, rows, s, L, w1, w2, elem_code, sm_scale,
        # dmajor, stream
        "mx_quantize_rows_launch": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _I, _P),
    },
    "mx_matmul": {
        # x, w, scale, out, workspace, M, N, K, splits, walk, stream
        "mx_matmul_fp4_halves_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # the same over fp8 halves (uint16 words), and over fp4 pairs (x in plane order)
        "mx_matmul_fp8_halves_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "mx_matmul_fp4_pair_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # workspace, out, M * N, splits, stream
        "mx_matmul_fp4_halves_reduce_launch": (_P, _P, _L, _I, _P),
        "mx_matmul_fp8_halves_reduce_launch": (_P, _P, _L, _I, _P),
        "mx_matmul_fp4_pair_reduce_launch": (_P, _P, _L, _I, _P),
    },
    "mx_matmul_1byte": {
        # x, w, scale, out, workspace, M, N, K, elem_code, act_fq_code, splits, walk, stream
        "mx_matmul_1byte_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        # workspace, out, M * N, splits, stream
        "mx_matmul_1byte_reduce_launch": (_P, _P, _L, _I, _P),
    },
    "mx_matmul_fp6q": {
        # x, planes, scale, out, workspace, M, N, K, elem_code, splits, walk, stream
        "mx_matmul_fp6q_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        # workspace, out, M * N, splits, stream
        "mx_matmul_fp6q_reduce_launch": (_P, _P, _L, _I, _P),
    },
    "mx_matmul_int8dot": {
        # x codes (dot order), x scale factors (K/32, Mp), w codes, w scales, out, workspace, M, N, K, Mp,
        # splits, walk, reduce (the two-pass form's reduce in the same call), stream
        "mx_matmul_int8dot_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "mx_matmul_fp8dot_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        # workspace, out, M * N, splits, stream
        "mx_matmul_int8dot_reduce_launch": (_P, _P, _L, _I, _P),
        "mx_matmul_fp8dot_reduce_launch": (_P, _P, _L, _I, _P),
    },
    "mx_grouped_matmul": {
        # x, w, scale, tile_expert, tile_rows, out, workspace, R, N, K, E, tm, elem_code (-1: bf16),
        # ext (live rows of a tile at most), nb (x rows a CTA), splits, walk, fault (0), stream
        "mx_grouped_matmul_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "mx_router": {
        # x, w, out, rows, H, E, f32_out, stream
        "mx_router_logits_launch": (_P, _P, _P, _L, _I, _I, _I, _P),
    },
    "mx_mla": {
        # q_lat, q_rot, lat codes, lat scales, rot codes, rot scales, q_off, kv_len, out, workspace,
        # tickets, b, rows, n, L, r, dr, chunk, the grid's chunks, sm_scale, elem_code (-1: bf16), fault (0),
        # stream
        "mx_mla_attention_launch": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P
        ),
    },
    "mx_mla_int8dot": {
        # q_lat, q_rot (bf16), lat codes, lat scales, rot codes, rot scales, q_off, kv_len (null: the two
        # numbers that follow), q_off number, kv_len number, out, workspace, tickets, q_lat codes, q_lat
        # scales, q_rot codes, q_rot scales (null, or outputs), b, n, L, r, dr, tile, positions a CTA, the
        # grid's tiles, sm_scale, fault (0), stream
        "mx_mla_attention_int8dot_launch": (
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
            _I, _P
        ),
    },
    "mx_rmsnorm": {
        # x, weight, out, rows, D, eps, elem_code of the fused fake-quantize (-1: none), stream
        "mx_rmsnorm_launch": (_P, _P, _P, _L, _I, _F, _I, _P),
    },
    "mx_attention": {
        # q, kd, ks, vd, vs, q_off, kv_len (null: the two numbers that follow), q_off number, kv_len
        # number, out, b, hq, hkv, sq, L, d, tile, positions a CTA, the grid's CTAs, wide (64-row tiles),
        # sm_scale, elem_code, fault (0), stream
        "mx_cached_attention_launch": (
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P
        ),
    },
    "mx_attention_chunkdot": {
        # q, kd, ks, vd, vs, q_off, kv_len (null: the two numbers that follow), q_off number, kv_len
        # number, out, b, hq, hkv, L, d, tile, positions a CTA, the grid's CTAs, sm_scale, fault (0), stream
        "mx_cached_attention_chunkdot_launch": (
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P
        ),
    },
    "mx_attention_dmajor": {
        # the arguments of mx_cached_attention_launch, over the d-major cache
        "mx_cached_attention_dmajor_launch": (
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P
        ),
    },
    "mx_attention_int8dot": {
        # q, kd, ks, vd, vs, q_off, kv_len, out, workspace, tickets, q codes and q scales (null, or
        # outputs), b, hq, hkv, L, d, tile, the grid's tiles, sm_scale, fault (0), stream
        "mx_cached_attention_int8dot_launch": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P
        ),
    },
}

# Element format codes shared with csrc/mx_common.cuh.
ELEM_CODES = {"float8_e4m3": 0, "float4_e2m1": 1, "float6_e3m2": 2, "float6_e2m3": 3, "int8": 4}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel source that has no current library, all nvcc
    processes at once; returns ``{source name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def _bind(handle: ctypes.CDLL, src: str) -> ctypes.CDLL:
    for fn, argtypes in SIGNATURES[src].items():
        getattr(handle, fn).argtypes = list(argtypes)
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def build_variant(name: str, *flags: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with extra ``flags`` (a diagnostic build,
    e.g. ``-DB8_PHASE_PROFILE``) into a library of its own, loaded and bound
    like :func:`lib`'s; not counted, not cached across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(" ".join(flags).encode()).hexdigest()[:8]
    out = BUILD_DIR / f"lib{name}-variant-{tag}-{os.getpid()}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC_DIR), "-o", str(out),
                    str(CSRC_DIR / f"{name}.cu")], check=True)
    return _bind(ctypes.CDLL(str(out)), name)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all on first use)."""
    with _lock:
        if not _libs:
            for src, path in build_all().items():
                _libs[src] = _bind(ctypes.CDLL(str(path)), src)
        return _libs[name]


def launch(src: str, fn: str, *args, count: bool = True, name: str = "") -> None:
    """Call ``fn`` of ``csrc/<src>.cu`` on PyTorch's current stream, raise on
    a launch error, and count the launch under ``name`` (default: ``fn``
    without ``_launch``; ``count=False``: a kernel's second pass, which its
    first launch has counted)."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(src), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError {rc}")
    if count:
        LAUNCHES[name or fn.removesuffix("_launch")] += 1
