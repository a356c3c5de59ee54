"""ctypes bindings for the native C++ image-loading runtime.

The port's own copy of ``yolo_v3_tpu/data/native_loader.py``.  The library
is ``csrc/yolodata.cc``, built by ``ops/_build.py`` (:func:`build_host`,
g++ with the JAX package's flags, hash-keyed under the package's git-ignored
``build/``).  It exposes a threaded decode+letterbox prefetcher: submit
image paths, receive ready-to-device float32 or uint8 NHWC letterboxed
buffers with original dims (the native replacement for the reference's
OpenCV-in-Python-workers input path, reference dataset.py:194-195,
evaluate.py:216).

Unlike the JAX package, nothing here turns itself off: without a toolchain
or libjpeg, :func:`load_library` raises with g++'s stderr.  A file that is
not a decodable JPEG comes back ``ok=False``, and callers fall back to the
OpenCV path for that image alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np

from yolo_v3_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/yolodata.cc`` with its ctypes
    signatures.  Raises RuntimeError carrying the build's error."""
    lib = _build.load_host("yolodata")
    i64, i32, f32, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    pi64, pi32 = ctypes.POINTER(i64), ctypes.POINTER(i32)
    pf32, pu8 = ctypes.POINTER(f32), ctypes.POINTER(ctypes.c_uint8)
    aug = [f32, f32, f32, i32, i32, i32, i32, i32]      # dhue dsat dexp l r t b flip
    sigs = {
        "yolodata_create": (ptr, [i32]),
        "yolodata_destroy": (None, [ptr]),
        "yolodata_submit": (None, [ptr, i64, ctypes.c_char_p, i32, i32]),
        "yolodata_next": (i32, [ptr, pi64, pf32, i32, pi32, pi32]),
        "yolodata_submit_fmt": (None, [ptr, i64, ctypes.c_char_p, i32, i32, i32]),
        "yolodata_next_u8": (i32, [ptr, pi64, pu8, i32, pi32, pi32]),
        # the training-augmentation two-phase flow (csrc/yolodata.cc)
        "yolodata_submit_decode": (None, [ptr, i64, ctypes.c_char_p]),
        "yolodata_next_decoded": (i32, [ptr, pi64, pi32, pi32]),
        "yolodata_submit_aug": (None, [ptr, i64, *aug, i32, i32, i32]),
        "yolodata_drop_held": (None, [ptr, i64]),
        "yolodata_augment_buffer": (i32, [pu8, i32, i32, *aug, i32, i32, i32, pf32, pu8]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except RuntimeError:
        return False


class NativePrefetcher:
    """Threaded native decode+letterbox pipeline.

    Usage::

        with NativePrefetcher(n_threads=2) as pf:
            batch, orgs, ok = pf.load_letterboxed(paths, (416, 416))
    """

    def __init__(self, n_threads: int = 2, dtype: str = "float32"):
        """``dtype``: "float32" (normalized [0,1]) or "uint8" (cv2 pixel
        semantics: the int8 serving path's uint8 feed, 4x less host->device
        transfer)."""
        if dtype not in ("float32", "uint8"):
            raise ValueError(f"dtype must be 'float32' or 'uint8', got {dtype!r}")
        self._lib = load_library()
        self._handle = self._lib.yolodata_create(n_threads)
        self._fmt = 1 if dtype == "uint8" else 0

    def close(self):
        if self._handle:
            self._lib.yolodata_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def load_letterboxed(
        self, paths: Sequence[str], dim: Tuple[int, int]
    ) -> Tuple[np.ndarray, np.ndarray, List[bool]]:
        """Decode + letterbox a batch of JPEGs concurrently.

        Returns (imgs [B, out_h, out_w, 3] float32 or uint8, org_dims [B, 2]
        (w, h), ok flags).  Failed entries (non-JPEG, IO error) have
        ok=False and zero buffers: the caller retries those on the OpenCV
        path.
        """
        out_w, out_h = dim
        n = len(paths)
        for i, p in enumerate(paths):
            self._lib.yolodata_submit_fmt(
                self._handle, i, p.encode(), out_w, out_h, self._fmt
            )
        np_dtype = np.uint8 if self._fmt else np.float32
        imgs = np.zeros((n, out_h, out_w, 3), np_dtype)
        orgs = np.zeros((n, 2), np.float32)
        ok = [False] * n
        cap = out_w * out_h * 3
        buf = np.empty((cap,), np_dtype)
        tag = ctypes.c_int64()
        ow = ctypes.c_int()
        oh = ctypes.c_int()
        next_fn = (self._lib.yolodata_next_u8 if self._fmt
                   else self._lib.yolodata_next)
        c_ptr = ctypes.POINTER(ctypes.c_uint8 if self._fmt
                               else ctypes.c_float)
        for _ in range(n):
            status = next_fn(
                self._handle, ctypes.byref(tag),
                buf.ctypes.data_as(c_ptr), cap,
                ctypes.byref(ow), ctypes.byref(oh),
            )
            i = tag.value
            if status == 0:
                imgs[i] = buf.reshape(out_h, out_w, 3)
                orgs[i] = (ow.value, oh.value)
                ok[i] = True
        return imgs, orgs, ok

    def image_sizes(self, paths: Sequence[str]) -> Tuple[np.ndarray, List[bool]]:
        """(w, h) of each JPEG, decoded on the pool: [n, 2] int64 and ok
        flags.  Each decoded image is dropped as soon as its size arrives,
        and at most 16 are in flight, so memory stays bounded at any
        list length."""
        lib, h = self._lib, self._handle
        n = len(paths)
        sizes = np.zeros((n, 2), np.int64)
        ok = [False] * n
        tag, ow, oh = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
        window = 16
        submitted = 0
        for received in range(n):
            while submitted < min(n, received + window):
                lib.yolodata_submit_decode(h, submitted, paths[submitted].encode())
                submitted += 1
            status = lib.yolodata_next_decoded(h, ctypes.byref(tag), ctypes.byref(ow),
                                               ctypes.byref(oh))
            lib.yolodata_drop_held(h, tag.value)
            if status == 0:
                sizes[tag.value] = (ow.value, oh.value)
                ok[tag.value] = True
        return sizes, ok
