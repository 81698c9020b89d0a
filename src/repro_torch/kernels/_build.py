"""Build the package's CUDA sources into shared libraries at first use.

Every ``*.cu`` under a ``csrc/`` directory of this package is compiled by
its own ``nvcc`` process (all started together) into a shared library with
a plain C interface under ``<repo>/build/repro_torch/``, and loaded with
``ctypes``.  The library's file name carries a hash of its ``csrc/``
sources and the flags, so an edited source rebuilds and an unchanged one is
reused.  A build failure raises with the compiler's output; nothing falls
back to a plain version.

``-Xptxas -v`` is always on: its report (registers, shared memory and
spills per kernel) is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "sources", "build_all", "library"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_PKG = Path(__file__).resolve().parent.parent           # src/repro_torch
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"


def sources() -> dict[str, Path]:
    """``{stem: path}`` of every CUDA source in the package."""
    return {p.stem: p for p in sorted(_PKG.glob("**/csrc/*.cu"))}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(src.parent.glob("*.cu*")):       # .cu and .cuh
        digest.update(dep.name.encode())
        digest.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _build(src: Path) -> dict:
    """Build one source unless it is built already; see ``build_all``."""
    target = _target(src)
    log = target.with_suffix(".log")
    if target.exists():
        return {"path": str(target), "cached": True, "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique temp name: concurrent first uses may build the same source
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build of {src.name} failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, target)
    return {"path": str(target), "cached": False, "seconds": seconds, "log": proc.stdout}


def build_all(stems=None) -> dict[str, dict]:
    """Build the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all running at once.

    Returns ``{stem: {"path", "cached", "seconds", "log"}}``; ``log`` is
    nvcc's output (the ``-Xptxas -v`` report).  Raises ``RuntimeError`` if
    a build fails."""
    srcs = sources()
    stems = list(srcs) if stems is None else list(stems)
    unknown = [s for s in stems if s not in srcs]
    if unknown:
        raise KeyError(f"no CUDA source named {unknown}; known: {sorted(srcs)}")
    with ThreadPoolExecutor(max_workers=max(1, len(stems))) as pool:
        built = list(pool.map(lambda stem: _build(srcs[stem]), stems))
    return dict(zip(stems, built))


def library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of ``csrc/<stem>.cu``;
    callers keep the handle."""
    return ctypes.CDLL(build_all([stem])[stem]["path"])
