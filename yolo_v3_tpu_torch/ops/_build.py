"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` holds a kernel and a plain C launcher, compiled by
``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` inside the package
(the directory is git-ignored).  The hash covers the source, the headers
it includes from ``csrc/`` (``#include "..."``, followed recursively) and
the flags, so an edited source or header builds anew and an unchanged one
loads from the cache.  nvcc's report (ptxas: registers, spills, shared
memory, warnings) is kept beside the library as ``<name>-<hash>.log``.
Nothing here runs at import: the package imports on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


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


def source_digest(src: Path) -> str:
    """Hash of ``src``, of every header it includes with ``#include "..."``
    (relative to the including file, followed recursively) and of the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        digest.update(path.name.encode() + b"\0" + text)
        todo += [(path.parent / inc).resolve()
                 for inc in _INCLUDE.findall(text.decode("utf-8", "replace"))]
    return digest.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    its headers exists; return the shared library's path.  Raises with
    nvcc's stderr on failure."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"{name}-{source_digest(src)}.so"
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
        lib.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_log(name: str) -> str:
    """nvcc's report of the build of ``csrc/<name>.cu`` that :func:`build`
    returns (building it if needed)."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]
