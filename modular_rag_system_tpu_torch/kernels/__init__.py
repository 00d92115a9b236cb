"""Build and load the port's hand-written CUDA kernels.

Each ``*.cu`` file here holds a kernel's plain C entry point (``fused_topk.cu``
holds two: ``fused_topk`` and ``fused_topk_int8``, one kernel template
over three row types; ``mea_attention.cu`` two, the full and the
sliding-window mode: ``mea_attention`` and ``mea_attention_window``;
``clip_adamw.cu`` two, the trainer's update in two launches:
``clip_adamw_norm`` and ``clip_adamw_apply``); the ``*.cuh``
headers hold device code that several of them share.  A kernel's first
use compiles the one source that holds it (``build_all`` compiles every
source, one ``nvcc`` process each, all started together) for ``sm_90a``
into a shared library under ``_build/`` (named by the hash of the source
and the headers, so an edited source or header rebuilds), and loads it
with ``ctypes``.  A build or load failure raises: there is no fallback to
the plain PyTorch versions.

``launches`` counts kernel launches per kernel name (``KERNELS``, the C
entry points): each wrapper in ``ops/`` adds one where it launches its
kernel and nowhere else.  Wrappers run from several threads at once (the
HTTP server's query batcher), so the counts change under ``_lock``.

Build by hand (what ``build`` runs for each source):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so <name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
# kernel name (its C entry point and launch counter) -> the source file
# that holds it
KERNELS = {"binmax_int8": "binmax_int8", "fused_topk_int8": "fused_topk",
           "binmax": "binmax", "fused_topk": "fused_topk", "fine_scores": "fine_scores",
           "fine_topk": "fine_topk", "fine_binmax": "fine_binmax", "rescan": "rescan",
           "mea_attention": "mea_attention", "mea_attention_window": "mea_attention",
           "clip_adamw_norm": "clip_adamw",
           "clip_adamw_apply": "clip_adamw"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))

# dynamic shared memory one CTA may use on Hopper (227 KB); the launch
# plans in ``ops/`` size their tiles within it
SMEM_BYTES = 232_448

launches: Dict[str, int] = {name: 0 for name in KERNELS}
build_logs: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every entry point returns a cudaError_t as int
_ARGTYPES = {
    # E_q, q_i8, scales, q_scale, cap, Q, d, bin_width, query tile, out, stream
    "binmax_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # E_q, scales, q_bf16, Q, d, count, k, bin_width, cfg, QB, S, R, ws,
    # vals, ids, stream
    "fused_topk_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # E, is_bf16, q_bf16, cap, Q, d, bin_width, out, stream
    "binmax": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    # E, is_bf16, q_bf16, Q, d, count, k, bin_width, cfg, QB, S, R, ws,
    # vals, ids, stream
    "fused_topk": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # E_c3, mode (0 bf16, 1 int8, 2 int4), scales3, q_bf16, blk, vcnt, perm,
    # Q, L, d, P, out, stream
    "fine_scores": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # E_c3, mode, scales3, q_bf16, keys, perm, pvc, P, L, nblocks, Q, d, k,
    # cfg, QB, G, part, vals, slots, stream
    "fine_topk": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _P, _P, _P, _P],
    # E_c3, mode, scales3, q_bf16, blk, vcnt, keys, kbytes, perm, window, P,
    # L, nblocks, d, out (Q, L), ncand, stream
    "fine_binmax": [_P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # E, is_bf16, q_bf16, keys, kbytes, perm, window, Q, d, count, kb,
    # bin_width, k, ws, stages, warp_sel, vals, ids, stream
    "rescan": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P],
    # q, k, v, pad, is_bf16, B, L, H, dh, scale, design, work, out, stream
    "mea_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P],
    # q, k, v, pad, is_bf16, B, L, H, dh, scale, window, out, stream
    "mea_attention_window": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P],
    # g, n, split, grid, partials, stream
    "clip_adamw_norm": [_P, _I, _I, _I, _P, _P],
    # p, g, mu, nu, n, partials, grid, split_sum, norm_out, 1 / bc1, 1 / bc2,
    # wd, -lr, clip, stream
    "clip_adamw_apply": [_P, _P, _P, _P, _I, _P, _I, _P, _P] + [_F] * 5 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha1((KERNEL_DIR / f"{name}.cu").read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Compile each of ``sources`` that has no current build, one
    ``nvcc`` per source in parallel; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(KERNEL_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: _target(name) for name in sources}


def build_all() -> Dict[str, Path]:
    """Compile every kernel source that has no current build."""
    return build(SOURCES)


def library(name: str) -> ctypes.CDLL:
    """The loaded library that holds kernel ``name`` (building its
    source at first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = KERNELS[name]
            lib = ctypes.CDLL(str(build([src])[src]))
            for n, s in KERNELS.items():
                if s == src:
                    fn = getattr(lib, n)
                    fn.argtypes = _ARGTYPES[n]
                    fn.restype = ctypes.c_int
                    _libs[n] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raises on a CUDA error."""
    err = getattr(library(name), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    with _lock:
        launches[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in launches:
            launches[name] = 0
