"""ctypes bindings for the native (C++) data-path runtime (counterpart
of ``gfe_mamba_tpu/data/native.py``).

``native/gfe_io.cpp`` provides gzip NIfTI-1 decode, trilinear resample,
adaptive normalization, and a threaded batch loader.  This module builds
its own copy of the library on first use, ``g++ -O3 -std=c++17 -fPIC
-shared ... -lz -lpthread``, into ``gfe_mamba_torch/_build/`` under a
name that carries a hash of the source (never into ``native/``, where
the JAX package's ``make -C native`` writes), and the datasets fall back
to the pure-Python codec when no toolchain is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PACKAGE), "native", "gfe_io.cpp")
_BUILD_DIR = os.path.join(_PACKAGE, "_build")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libgfe_io_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile to a temporary name in the build directory, then rename,
    so a concurrent build never loads a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SOURCE, "-lz",
                        "-lpthread"], check=True, capture_output=True,
                       timeout=240)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SOURCE):
        return None
    path = _lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.gfe_load_volume.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.gfe_load_volume.restype = ctypes.c_int
    lib.gfe_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.gfe_load_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def load_volume(path: str, target_shape, normalize: bool = True) -> np.ndarray:
    """Decode + (optional) adaptive-normalize + trilinear resample one
    NIfTI file natively.  Returns (x, y, z) float32."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    shape = (ctypes.c_int64 * 3)(*[int(s) for s in target_shape])
    out = np.empty(tuple(target_shape), np.float32)
    rc = lib.gfe_load_volume(
        path.encode(), shape, int(normalize),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"native NIfTI decode failed ({rc}) for {path}")
    # native fills Fortran-order (x fastest); out was allocated C-order
    # over (x, y, z) -> reinterpret
    flat = out.reshape(-1)
    return flat.reshape(tuple(target_shape), order="F").copy()


def load_batch(paths, target_shape, normalize: bool = True,
               num_threads: int = 4) -> np.ndarray:
    """Threaded native decode of many files -> (n, x, y, z) float32."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    shape = (ctypes.c_int64 * 3)(*[int(s) for s in target_shape])
    out = np.empty((n,) + tuple(target_shape), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.gfe_load_batch(
        arr, n, shape, int(normalize), num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise IOError(f"native batch decode: {failures}/{n} failures")
    flat = out.reshape(n, -1)
    return np.stack([
        flat[i].reshape(tuple(target_shape), order="F") for i in range(n)
    ])
