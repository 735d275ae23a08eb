"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``build/kernels/<hash>/`` beside the
package (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so a changed source rebuilds and a repeated run reuses the
library. Only a CUDA launch reaches this module: the CPU paths never
import nvcc or the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]
LIB_NAME = "librepas_kernels.so"

# Wrapper calls that launched their kernel, by kernel. A wrapper adds one
# where it launches, and nowhere else; callers may reset the counts.
launches = {"ccl": 0, "ccl_tiled": 0, "patch_extract": 0, "pointcloud": 0,
            "patch_blk": 0, "patch_exact": 0, "eig3": 0, "kabsch3": 0,
            "eig9": 0, "grid_query": 0}

# an entry point's return code when the CUDA driver lacks a call (csrc/*.cu)
NO_DRIVER_CALL = -100000

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output (ptxas -v resource use) of a build
build_seconds = None    # wall time of this process's build, None if reused

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # mask, out, aux, B, H, W, iters, converge, counter, cluster,
    # band_rows, group, device, stream
    "repas_ccl": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # device, unsigned long long[6] out
    "repas_ccl_counts": [_I, _P],
    # W, device, int[4] out
    "repas_ccl_limits": [_I, _I, _P],
    # cluster, band_rows, W, device, int* out
    "repas_ccl_max_clusters": [_I, _I, _I, _I, _P],
    # mask, labels, out, agg_v, agg_b, B, H, W, along_rows, chunk, device,
    # stream
    "repas_seg_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # pyr, starts, out, B, C, Hp, W, ah, aw, elem_size, yi, y_unit,
    # x_unit, path, bh, bw, stages, grid, device, stream
    "repas_patch_extract": [_P, _P, _P, *[_I] * 16, _P],
    # depth, rgb, K, scale, out, B, H, W, device, stream
    "repas_pointcloud": [_P, _P, _P, ctypes.c_float, _P, _I, _I, _I, _I, _P],
    # A, w, V, sweeps (or null), N, device, stream (csrc/eig3.cu)
    "repas_eig3": [_P, _P, _P, _P, _L, _I, _P],
    # A, w, V, sweeps (or null), N, is_double, device, stream
    # (csrc/eig9.cu)
    "repas_eig9": [_P, _P, _P, _P, _L, _I, _I, _P],
    # H, R, sweeps (or null), N, device, stream (csrc/kabsch3.cu)
    "repas_kabsch3": [_P, _P, _P, _L, _I, _P],
    # cell_of, slot stride, cell stride, origin, cell, target, query,
    # mask, idx, dist, Q, slots, nx, ny, nz, device, stream
    # (csrc/grid_query.cu)
    "repas_grid_query": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _L,
                         _I, _I, _I, _I, _I, _P],
    # pred, body stream, device, stream (csrc/graph_if.cu)
    "repas_if_begin": [_P, _P, _I, _P],
    # body stream, device
    "repas_if_end": [_P, _I],
    # pred, body stream, device, stream, handle out
    "repas_while_begin": [_P, _P, _I, _P, _P],
    # pred, handle, body stream, device, body nodes out
    "repas_while_end": [_P, ctypes.c_ulonglong, _P, _I, _P],
    # stream, device, nodes out
    "repas_capture_nodes": [_P, _I, _P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit on PATH or under CUDA_HOME")


def build() -> Path:
    """Compile csrc/*.cu into the hashed build directory unless a library
    for these sources is already there. Returns the library's path."""
    global build_log, build_seconds
    out_dir = BUILD_ROOT / source_digest()
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a private directory and rename the library into place:
    # concurrent builds (test workers) never load a half-written library
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compiler before reporting any failure
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in jobs]
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
               *[c[c.index("-o") + 1] for c, _, _ in logs]]
        for c, out, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}):\n"
                                   f"{' '.join(c)}\n{out}")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp / LIB_NAME, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(out for _, out, _ in logs) + res.stdout + res.stderr
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repas_error_string.argtypes = [ctypes.c_int]
            lib.repas_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def loaded():
    """The kernel library if this process has loaded it, else None."""
    return _lib


def check(name: str, rc: int) -> None:
    """Raise if C entry point `name` returned a CUDA error (a runtime
    error code, or a CUDA driver call's CUresult negated)."""
    if rc == NO_DRIVER_CALL:
        raise RuntimeError(f"{name}: the CUDA driver lacks a call it needs")
    if rc < 0:
        raise RuntimeError(f"{name}: CUDA driver error (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{library().repas_error_string(rc).decode()}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream; raise if
    the launch reported an error (cudaGetLastError after each launch)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    check(name, getattr(library(), name)(*args, device.index, stream))
