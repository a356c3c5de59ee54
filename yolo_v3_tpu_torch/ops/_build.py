"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` holds a kernel and a plain C launcher, compiled by
``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` inside the package
(the directory is git-ignored).  The hash covers the source and the flags,
so an edited source builds anew and an unchanged one loads from the cache.
Nothing here runs at import: the package imports on hosts without nvcc.
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
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr (the ptxas register, spill and shared-memory report) of each
# build made in this process, by source name
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from yolo_v3_tpu_torch/csrc at first use")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists;
    return the shared library's path.  Raises with nvcc's stderr on failure."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[name] = proc.stderr
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]
