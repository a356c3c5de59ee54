"""Plain letterbox: an aspect-preserving cubic resize into a gray canvas.

The geometry truncates as darknet's ``letterbox_image`` does: ratio =
min(W / w, H / h), resized size int(w * ratio) x int(h * ratio), pads
floor((W - rw) / 2) and floor((H - rh) / 2), gray 128 / 255.  The resize is
OpenCV's INTER_CUBIC (Keys kernel, a = -0.75, half-pixel centres, replicated
borders, no antialias), as a [dst, src] weight matrix a side, in float64;
overshoot is clipped to [0, 1].  ``precision="tf32"`` computes it as the
tensor cores would with TF32 on: float32 sums of operands rounded to 10
mantissa bits (the control of the comparison).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import round_mantissa

PAD = 128.0 / 255.0


def geometry(w: int, h: int, out: int):
    ratio = min(out / w, out / h)
    rw, rh = int(w * ratio), int(h * ratio)
    return rw, rh, (out - rw) // 2, (out - rh) // 2


def cubic_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    scale = src / dst
    mat = np.zeros((dst, src), np.float64)
    for i in range(dst):
        s = (i + 0.5) * scale - 0.5
        base = math.floor(s)
        taps = [base - 1 + t for t in range(4)]
        wts = []
        for tap in taps:
            t = abs(tap - s)
            if t <= 1:
                wts.append((a + 2) * t ** 3 - (a + 3) * t ** 2 + 1)
            elif t < 2:
                wts.append(a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a)
            else:
                wts.append(0.0)
        total = sum(wts)
        for tap, wt in zip(taps, wts):
            mat[i, min(max(tap, 0), src - 1)] += wt / total
    return mat


def letterbox(img: np.ndarray, out: int, device, precision: str = "fp64") -> torch.Tensor:
    """One HWC uint8 image -> [out, out, 3] in [0, 1] (float64, or float32
    for ``precision="tf32"``)."""
    h, w = img.shape[:2]
    rw, rh, xp, yp = geometry(w, h, out)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device, torch.float64) / 255.0
    wh = torch.from_numpy(cubic_matrix(h, rh)).to(device)
    ww = torch.from_numpy(cubic_matrix(w, rw)).to(device)
    if precision == "tf32":
        x, wh, ww = (round_mantissa(t.float(), 10) for t in (x, wh, ww))
        y = round_mantissa(torch.einsum("hs,swc->hwc", wh, x), 10)
        y = torch.einsum("ws,hsc->hwc", ww, y)
    elif precision == "fp64":
        y = torch.einsum("ws,hsc->hwc", ww, torch.einsum("hs,swc->hwc", wh, x))
    else:
        raise ValueError(f"unknown precision {precision!r}")
    canvas = torch.full((out, out, 3), PAD, dtype=y.dtype, device=device)
    canvas[yp:yp + rh, xp:xp + rw] = y.clamp(0.0, 1.0)
    return canvas


def letterbox_batch(images, out: int, device, precision: str = "fp64") -> torch.Tensor:
    return torch.stack([letterbox(im, out, device, precision) for im in images])
