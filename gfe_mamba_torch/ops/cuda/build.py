"""Build and load the hand-written CUDA kernels of ``gfe_mamba_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``.  The
build runs at first use, from the checkout's sources alone, into
``gfe_mamba_torch/_build`` (listed in ``.gitignore``).  A library's file
name carries a hash of its source, of the headers the sources share
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  ``build`` starts one ``nvcc`` per
source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("conv3d", "conv3d_dw", "group_norm", "selective_scan",
           "selective_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source not built yet, all in parallel.

    Returns each source's ``-Xptxas -v`` report (registers, shared memory,
    spills); raises ``RuntimeError`` if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    reports = {}
    for name in names:
        target = library_path(name)
        log = target.with_suffix(".log")
        if target.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target, log)
    failed = []
    for name, (proc, tmp, target, log) in jobs.items():
        output, _ = proc.communicate()
        reports[name] = output
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        log.write_text(output)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build((name,))
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
