"""ctypes bindings for the native host-I/O runtime (native/repas_io.cpp).

Port of ``repas_tpu/io/native.py``. The reference loads a library that
``make -C native`` built beforehand; the port builds it at first use
instead, with the Makefile's recipe (``g++ -O3 -fPIC -shared -std=c++17
-lz -lpthread``, without ``-march=native``), into
``build/native/<hash of source and flags>/librepas_io.so`` beside the
package (git-ignored), so a changed source rebuilds and a repeated run
reuses the library. Where the library cannot be built (no compiler, no
zlib headers, no source) every reader returns None and the caller falls
back to PIL; ``build_error`` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "repas_io.cpp"
BUILD_ROOT = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LINK_LIBS = ["-lz", "-lpthread"]
LIB_NAME = "librepas_io.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_lock = threading.Lock()
build_error: Optional[str] = None   # why the library is unavailable


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_LIBS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile native/repas_io.cpp into the hashed build directory unless
    a library for this source is already there. Raises RuntimeError when
    it cannot."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found")
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    # build privately, then rename into place: concurrent builds (test
    # workers) never load a half-written library
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE),
               *LINK_LIBS]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                               f"{res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp / LIB_NAME, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load_library() -> Optional[ctypes.CDLL]:
    """The codec library, built on first call; None if it cannot be."""
    global _LIB, _TRIED, build_error
    with _lock:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            build_error = str(e)
            return None
        lib.repas_png_info.restype = ctypes.c_int
        lib.repas_png_info.argtypes = [ctypes.c_char_p] + \
            [ctypes.POINTER(ctypes.c_int)] * 4
        lib.repas_png_decode.restype = ctypes.c_int
        lib.repas_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.repas_png_decode_batch.restype = None
        lib.repas_png_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def png_info(path) -> Optional[tuple[int, int, int, int]]:
    lib = load_library()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    b = ctypes.c_int()
    r = lib.repas_png_info(str(path).encode(), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(c), ctypes.byref(b))
    if r != 0:
        return None
    return w.value, h.value, c.value, b.value


def _drop_alpha(out: np.ndarray, c: int) -> np.ndarray:
    """Gray+alpha -> gray, RGBA -> RGB (the reference's normalization)."""
    if c == 2:
        return np.ascontiguousarray(out[..., 0])
    if c == 4:
        return np.ascontiguousarray(out[..., :3])
    return out


def read_png(path) -> Optional[np.ndarray]:
    """Decode a PNG natively. Returns uint8 (H,W[,C]) or uint16 (H,W), or
    None when the codec can't handle the file (caller falls back)."""
    lib = load_library()
    if lib is None:
        return None
    info = png_info(path)
    if info is None:
        return None
    w, h, c, bits = info
    dtype = np.uint16 if bits == 16 else np.uint8
    out = np.empty((h, w, c) if c > 1 else (h, w), dtype=dtype)
    r = lib.repas_png_decode(str(path).encode(),
                             out.ctypes.data_as(ctypes.c_void_p))
    if r != 0:
        return None
    return _drop_alpha(out, c)


def read_png_batch(paths: Sequence, n_threads: int = 0
                   ) -> Optional[np.ndarray]:
    """Threaded batch decode of same-shape PNGs -> (N,H,W[,C]) array."""
    lib = load_library()
    if lib is None or not paths:
        return None
    info = png_info(paths[0])
    if info is None:
        return None
    w, h, c, bits = info
    dtype = np.uint16 if bits == 16 else np.uint8
    n = len(paths)
    shape = (n, h, w, c) if c > 1 else (n, h, w)
    out = np.empty(shape, dtype=dtype)
    frame_bytes = out.strides[0]
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    statuses = (ctypes.c_int * n)()
    lib.repas_png_decode_batch(arr, n, out.ctypes.data_as(ctypes.c_void_p),
                               frame_bytes, statuses, n_threads)
    if any(statuses[i] != 0 for i in range(n)):
        return None
    return _drop_alpha(out, c)
