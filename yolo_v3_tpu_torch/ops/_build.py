"""Build the package's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` holds a kernel and a plain C launcher, compiled by
``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` inside the package
(the directory is git-ignored); each ``csrc/<name>.cc`` is host code (the
image decode and augment pool, ``yolodata.cc``), compiled by ``g++`` with
the JAX package's flags into ``build/<name>-<hash>.so`` the same way
(:func:`build_host`).  The hash covers the source, the headers it includes
from ``csrc/`` (``#include "..."``, followed recursively) and the flags, so
an edited source or header builds anew and an unchanged one loads from the
cache.  Each build writes a temporary file and renames it into place, so
processes that build the same source at once never load a partial library.
The compiler's report (nvcc: ptxas registers, spills, shared memory,
warnings) is kept beside the library as ``<name>-<hash>.log``.  Nothing
here runs at import: the package imports on hosts without a compiler.
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

# the JAX package's g++ command (yolo_v3_tpu/data/native_loader.py): flags
# before the source, libraries after it
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_LIBS = ("-ljpeg", "-lpthread")

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


def source_digest(src: Path, flags=NVCC_FLAGS) -> str:
    """Hash of ``src``, of every header it includes with ``#include "..."``
    (relative to the including file, followed recursively) and of the
    flags."""
    digest = hashlib.sha256(" ".join(flags).encode())
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


def _compile(src: Path, flags, command) -> Path:
    """Build ``src`` into ``build/<stem>-<hash>.so`` unless that file exists:
    ``command(out)`` is the compiler's argv writing to ``out``, a temporary
    file renamed into place on success.  Raises with the compiler's stderr
    on failure."""
    lib = BUILD_DIR / f"{src.stem}-{source_digest(src, flags)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        argv = command(tmp)
        try:
            proc = subprocess.run(argv, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"{argv[0]} not found building {src.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(argv[0])} failed building {src.name} "
                f"(exit {proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    its headers exists; return the shared library's path.  Raises with
    nvcc's stderr on failure."""
    src = CSRC_DIR / f"{name}.cu"
    return _compile(src, NVCC_FLAGS, lambda out: [_nvcc(), *NVCC_FLAGS, "-o", out, str(src)])


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cc`` with g++ (no ``-march``,
    no fast-math: the JAX build's arithmetic) unless a build of this exact
    source exists; return the shared library's path.  Raises with g++'s
    stderr on failure (a missing ``jpeglib.h`` or libjpeg, for one)."""
    src = CSRC_DIR / f"{name}.cc"
    return _compile(src, HOST_FLAGS + HOST_LIBS,
                    lambda out: ["g++", *HOST_FLAGS, str(src), "-o", out, *HOST_LIBS])


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


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cc``; one handle per process.
    Raises RuntimeError where it cannot be built or loaded (a library whose
    dependencies this host lacks, e.g. one built on another machine)."""
    with _LOCK:
        key = f"{name}.cc"
        if key not in _LIBS:
            path = build_host(name)
            try:
                _LIBS[key] = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
        return _LIBS[key]
