"""Native-augmented training input path.

The port's own copy of ``yolo_v3_tpu/data/native_aug.py``.  It splits the darknet training pipeline (HSV jitter -> per-side crop/pad ->
flip -> letterbox, reference transforms.py:77-209) across the
Python/C++ boundary so the per-sample pixel work runs on the C++ thread
pool (csrc/yolodata.cc) while determinism stays bit-identical to the
in-Python path:

* random PARAMETERS are drawn here, in Python, from the per-sample
  ``np.random.Generator`` in exactly the order the transform classes in
  :mod:`yolo_v3_tpu_torch.data.transforms` draw them — same seed, same draws,
  same schedule/resume behavior;
* PIXEL work (cv2-exact integer HSV, crop/pad, flip, cubic letterbox)
  runs in C++ (tests/test_torch_native.py pins the parity bars);
* LABEL geometry is recomputed here with the very same numpy helpers the
  Python transforms use, so labels are bit-identical.

Two-phase protocol (the crop draw bounds depend on the original dims):
``submit_decode`` -> ``next_decoded`` (dims arrive) -> draw params ->
``submit_aug`` -> ``next`` (augmented, letterboxed pixels).

Replaces the reference's DataLoader worker processes for the training
path (reference dataset.py:461-465, evaluate.py:216) without the
pickling cost of the multiprocess pool in :mod:`yolo_v3_tpu_torch.data.loader`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yolo_v3_tpu_torch.data import transforms as T
from yolo_v3_tpu_torch.data.native_loader import load_library
from yolo_v3_tpu_torch.ops.boxes import letterbox_params

Sample = Dict[str, object]


# ---------------------------------------------------------------------------
# Parameter drawing — MUST mirror transforms.py draw-for-draw
# ---------------------------------------------------------------------------

@dataclass
class AugParams:
    """One sample's augmentation draw (pixel-path inputs)."""

    dhue: float = 0.0
    dsat: float = 1.0
    dexp: float = 1.0
    left: int = 0
    right: int = 0
    top: int = 0
    bottom: int = 0
    flip: bool = False
    # False only for a degenerate crop draw (new dim < 1): the Python path
    # then skips the crop ENTIRELY — including the label clip/filter that
    # otherwise runs even for an identity (all-zero) draw and can drop
    # out-of-frame boxes (transforms.py:189-209).
    crop_applied: bool = True


@dataclass(frozen=True)
class NativeAugSpec:
    """Hyperparameters extracted from a training Compose
    (:func:`compile_transform`)."""

    hue: float
    saturation: float
    exposure: float
    jitter: float
    area_thr: float
    flip_p: float
    max_labels: int
    # emit uint8 letterboxed pixels (the ToArray(keep_uint8=True) contract:
    # device-side /255 in the train step) instead of float32 [0,1]
    feed_u8: bool = False


def compile_transform(compose) -> Optional[NativeAugSpec]:
    """Map a :class:`~yolo_v3_tpu_torch.data.transforms.Compose` onto the native
    pixel path.  Returns None when the pipeline isn't exactly the darknet
    training chain (e.g. ``extra_aug=True``, custom pad values, eval
    pipelines) — callers then stay on the Python path."""
    steps = getattr(compose, "transforms", None)
    if not steps or len(steps) != 5:
        return None
    hsv, crop, flip, lbox, toarr = steps
    if not (isinstance(hsv, T.HSVAug) and isinstance(crop, T.RandomJitterCrop)
            and isinstance(flip, T.RandomHorizontalFlip)
            and isinstance(lbox, T.Letterbox) and isinstance(toarr, T.ToArray)):
        return None
    if crop.pad_value != 128 or lbox.pad_value != 128:
        return None
    if toarr.max_label_cols != 5:
        return None
    return NativeAugSpec(
        hue=hsv.hue, saturation=hsv.saturation, exposure=hsv.exposure,
        jitter=crop.jitter, area_thr=crop.area_thr, flip_p=flip.p,
        max_labels=toarr.max_labels, feed_u8=toarr.keep_uint8,
    )


def draw_aug_params(rng: np.random.Generator, w: int, h: int,
                    spec: NativeAugSpec) -> AugParams:
    """Consume the per-sample Generator in the exact order HSVAug ->
    RandomJitterCrop -> RandomHorizontalFlip do (transforms.py:149-229),
    so the native path reproduces the Python path's randomness bit for
    bit.  Degenerate crop draws (new dim < 1) collapse to identity, like
    RandomJitterCrop's guard."""
    dhue = float(rng.uniform(-spec.hue, spec.hue) * 179)
    dsat = float(T.rand_scale(rng, spec.saturation))
    dexp = float(T.rand_scale(rng, spec.exposure))
    dw, dh = int(w * spec.jitter), int(h * spec.jitter)
    left = int(rng.integers(-dw, dw + 1))
    right = int(rng.integers(-dw, dw + 1))
    top = int(rng.integers(-dh, dh + 1))
    bottom = int(rng.integers(-dh, dh + 1))
    crop_applied = w - left - right >= 1 and h - top - bottom >= 1
    if not crop_applied:
        left = right = top = bottom = 0
    flip = bool(rng.random() < spec.flip_p)
    return AugParams(dhue, dsat, dexp, left, right, top, bottom, flip,
                     crop_applied)


def transform_labels(
    label: Optional[np.ndarray], w: int, h: int, p: AugParams,
    dim: Tuple[int, int], spec: NativeAugSpec,
) -> Tuple[np.ndarray, np.ndarray]:
    """Label geometry for the native pixel path: jitter-crop shift +
    clip/filter, flip, letterbox — the same numpy ops (and dtypes) as
    RandomJitterCrop/RandomHorizontalFlip/Letterbox apply, so outputs are
    bit-identical.  Returns (filled [max_labels, 5] label, lb_reverter)."""
    out_w, out_h = dim
    cw, ch = w - p.left - p.right, h - p.top - p.bottom
    if p.crop_applied and label is not None and len(label):
        corners = T._labels_to_corners(label, w, h)
        corners[:, [1, 3]] -= p.left
        corners[:, [2, 4]] -= p.top
        corners = T.clip_and_filter_boxes(corners, cw, ch, spec.area_thr)
        label = T._corners_to_labels(corners, cw, ch)
    if p.flip and label is not None and len(label):
        label = label.copy()
        label[:, 1] = 1.0 - label[:, 1]
    rw, rh, xp, yp, _ = letterbox_params(cw, ch, out_w, out_h)
    reverter = np.array([cw, ch, rw, rh, xp, yp], np.float32)
    if label is not None and len(label):
        corners = T._labels_to_corners(label, cw, ch)
        scale = rw / cw
        corners[:, 1:5] *= scale
        corners[:, [1, 3]] += xp
        corners[:, [2, 4]] += yp
        label = T._corners_to_labels(corners, out_w, out_h)
    return T.fill_label(label, spec.max_labels), reverter


# ---------------------------------------------------------------------------
# Synchronous buffer API (parity tests / single images)
# ---------------------------------------------------------------------------

def augment_buffer(
    rgb: np.ndarray, p: AugParams, dim: Tuple[int, int],
    do_hsv: bool = True, dtype: str = "float32",
) -> np.ndarray:
    """Run the native augmentation chain on an in-memory HWC uint8 RGB
    buffer (bypasses JPEG decode — used by the parity tests)."""
    lib = load_library()
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"augment_buffer takes HWC uint8 RGB, got {rgb.dtype} {rgb.shape}")
    rgb = np.ascontiguousarray(rgb)
    out_w, out_h = dim
    h, w = rgb.shape[:2]
    if dtype == "uint8":
        out = np.empty((out_h, out_w, 3), np.uint8)
        fptr, uptr = None, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        out = np.empty((out_h, out_w, 3), np.float32)
        fptr, uptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), None
    lib.yolodata_augment_buffer(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        p.dhue, p.dsat, p.dexp, p.left, p.right, p.top, p.bottom,
        int(p.flip), int(do_hsv), out_w, out_h, fptr, uptr,
    )
    return out


# ---------------------------------------------------------------------------
# Batched two-phase loader (the training feed)
# ---------------------------------------------------------------------------

class NativeAugLoader:
    """Threaded decode+augment+letterbox batch assembler.

    ``load_batch`` submits every JPEG to the C++ pool, draws each sample's
    augmentation parameters as its dims arrive (per-sample Generator from
    the scheduled seed), submits the augment pass, and assembles training
    samples.  Entries the native path can't handle (non-JPEG, IO error)
    come back ``ok=False`` for the caller's cv2 fallback."""

    def __init__(self, n_threads: int = 4):
        self._lib = load_library()
        self._handle = self._lib.yolodata_create(n_threads)

    def close(self):
        if self._handle:
            self._lib.yolodata_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def load_batch(
        self,
        paths: Sequence[str],
        labels: Sequence[Optional[np.ndarray]],
        seeds: Sequence[int],
        dim: Tuple[int, int],
        spec: NativeAugSpec,
    ) -> Tuple[List[Optional[Sample]], List[bool]]:
        lib, h = self._lib, self._handle
        out_w, out_h = dim
        n = len(paths)
        for i, p in enumerate(paths):
            lib.yolodata_submit_decode(h, i, p.encode())

        params: List[Optional[AugParams]] = [None] * n
        dims: List[Tuple[int, int]] = [(0, 0)] * n
        ok = [False] * n
        tag = ctypes.c_int64()
        ow = ctypes.c_int()
        oh = ctypes.c_int()
        n_aug = 0
        for _ in range(n):
            status = lib.yolodata_next_decoded(
                h, ctypes.byref(tag), ctypes.byref(ow), ctypes.byref(oh))
            i = tag.value
            if status != 0:
                continue
            rng = np.random.default_rng(seeds[i])
            p = draw_aug_params(rng, ow.value, oh.value, spec)
            params[i] = p
            dims[i] = (ow.value, oh.value)
            # fmt=1 (uint8 letterbox out): the Python path's cv2.resize
            # emits uint8 before ToArray's /255, so quantizing to the u8
            # grid natively keeps pixel semantics identical
            lib.yolodata_submit_aug(
                h, i, p.dhue, p.dsat, p.dexp, p.left, p.right, p.top,
                p.bottom, int(p.flip), out_w, out_h, 1)
            n_aug += 1

        samples: List[Optional[Sample]] = [None] * n
        cap = out_w * out_h * 3
        buf = np.empty((cap,), np.uint8)
        uptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        for _ in range(n_aug):
            status = lib.yolodata_next_u8(
                h, ctypes.byref(tag), uptr, cap,
                ctypes.byref(ow), ctypes.byref(oh))
            i = tag.value
            if status != 0:
                continue
            w, hh = dims[i]
            label, reverter = transform_labels(
                labels[i], w, hh, params[i], dim, spec)
            img = buf.reshape(out_h, out_w, 3)
            samples[i] = {
                "img": (img.copy() if spec.feed_u8
                        else img.astype(np.float32) / 255.0),
                "label": label,
                "lb_reverter": reverter,
                "img_path": paths[i],
            }
            ok[i] = True
        return samples, ok
