"""Letterbox preprocessing: aspect-preserving resize + gray padding.

Port of ``yolo_v3_tpu/ops/letterbox.py``.  :func:`letterbox_device` resizes
on the tensor's device with OpenCV INTER_CUBIC weights as two matmuls;
:func:`letterbox_host` is the host OpenCV path (cv2 is imported only there).
Both normalize uint8 [0, 255] to float [0, 1] and pad with 128/255 gray.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from yolo_v3_tpu_torch.ops.boxes import letterbox_params
from yolo_v3_tpu_torch.utils.profiling import span

PAD_VALUE = 128.0 / 255.0


@functools.lru_cache(maxsize=256)
def _cubic_weight_matrix(src_len: int, dst_len: int, a: float = -0.75) -> np.ndarray:
    """Dense [dst, src] interpolation matrix for 1-D cubic resize with
    OpenCV INTER_CUBIC conventions: Keys kernel a=-0.75, half-pixel centers
    (src = (dst+0.5)*scale - 0.5), border-replicate clamping, no antialias.
    (Copied from the JAX package so the two resize identically.)"""

    def keys(t: np.ndarray) -> np.ndarray:
        t = np.abs(t)
        return np.where(
            t <= 1,
            (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
        )

    scale = src_len / dst_len
    mat = np.zeros((dst_len, src_len), np.float32)
    for i in range(dst_len):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        taps = np.arange(base - 1, base + 3)
        w = keys(taps - src)
        w = w / w.sum()
        for tap, wt in zip(taps, w):
            mat[i, min(max(tap, 0), src_len - 1)] += wt
    return mat


@functools.lru_cache(maxsize=256)
def _cubic_weights_on(src_len: int, dst_len: int, device: torch.device) -> torch.Tensor:
    """:func:`_cubic_weight_matrix` as a tensor on ``device``, uploaded once."""
    host = _cubic_weight_matrix(src_len, dst_len)
    with span("h2d"):
        return torch.from_numpy(host).to(device)


def resize_cubic_device(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """HWC float32 image resize as two matmuls with cv2-parity weights."""
    wh = _cubic_weights_on(x.shape[0], out_h, x.device)
    ww = _cubic_weights_on(x.shape[1], out_w, x.device)
    y = torch.tensordot(wh, x, dims=([1], [0]))        # [out_h, w, c]
    return torch.einsum("ws,hsc->hwc", ww, y)          # [out_h, out_w, c]


def letterbox_device(img: torch.Tensor, out_dim: Tuple[int, int]) -> torch.Tensor:
    """Letterbox one HWC image (uint8 or float) to (out_w, out_h) on its
    device; returns float32 [out_h, out_w, C] in [0, 1]."""
    out_w, out_h = out_dim
    h, w = img.shape[0], img.shape[1]
    rw, rh, xp, yp, _ = letterbox_params(w, h, out_w, out_h)
    x = img.to(torch.float32)
    if img.dtype == torch.uint8:
        x = x / 255.0
    # cubic overshoot -> clip to gamut, like the reference's uint8 saturation
    resized = resize_cubic_device(x, rh, rw).clamp(0.0, 1.0)
    canvas = torch.full((out_h, out_w, img.shape[2]), PAD_VALUE,
                        dtype=torch.float32, device=img.device)
    canvas[yp:yp + rh, xp:xp + rw] = resized
    return canvas


def letterbox_host_u8(img: np.ndarray, out_dim: Tuple[int, int]) -> np.ndarray:
    """Host letterbox with OpenCV INTER_CUBIC, kept in uint8."""
    import cv2

    out_w, out_h = out_dim
    h, w = img.shape[:2]
    rw, rh, xp, yp, _ = letterbox_params(w, h, out_w, out_h)
    canvas = np.full((out_h, out_w, img.shape[2]), 128, dtype=np.uint8)
    canvas[yp:yp + rh, xp:xp + rw] = cv2.resize(
        img, (rw, rh), interpolation=cv2.INTER_CUBIC)
    return canvas


def letterbox_host(img: np.ndarray, out_dim: Tuple[int, int]) -> np.ndarray:
    """Host letterbox, normalized float32."""
    return letterbox_host_u8(img, out_dim).astype(np.float32) / 255.0
