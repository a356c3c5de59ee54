"""Letterbox preprocessing: aspect-preserving resize + gray padding.

Port of ``yolo_v3_tpu/ops/letterbox.py``.  A batch for the device is staged
whole (:func:`stage_batch`): its images packed back to back in one uint8
block, pinned for a card and uploaded with one non-blocking copy, beside a
descriptor table of each image's geometry.  :func:`letterbox_batch`
letterboxes (or plainly resizes) the packed batch into one [B, dim, dim, 3]
float32 tensor: on a card with one launch of ``csrc/letterbox.cu``, which
replaces no TPU kernel (the JAX package letterboxes with XLA matmuls) and
exists so that a batch costs one upload and one launch instead of a blocking
upload and ~9 launches an image; it is bound by bytes (~92 MB at 32 images
of 640 x 480 to 416: ~27 us at 3.35 TB/s).  On the CPU it runs
:func:`letterbox_batch_ref`, the plain version: each image resized with
OpenCV INTER_CUBIC weights as two matmuls (``letterbox_device`` of the JAX
package).  :func:`letterbox_host` is the host OpenCV path (cv2 is imported
only there).  All normalize uint8 [0, 255] to float [0, 1] and pad with
128/255 gray.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from yolo_v3_tpu_torch.ops import _build
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


# -- the batch, staged whole -------------------------------------------------

# Columns of the descriptor table (int64 [B, DESC_COLS], csrc/letterbox.cu):
# the image's byte offset in the packed buffer, its width and height, its
# resized width and height, and its x and y pads.
DESC_COLS = 7
# The largest net size the kernel takes: its column taps (32 bytes a column)
# fill at most 227 KB of a block's shared memory.
MAX_DIM = 227 * 1024 // 32


def _descriptors(images: Sequence[np.ndarray], dim: int, letterbox: bool) -> np.ndarray:
    """The descriptor table of HWC uint8 RGB ``images`` for a square net
    input of ``dim``: letterboxed (:func:`letterbox_params`) or resized to
    the whole square; offsets of the images packed in order."""
    if not len(images):
        raise ValueError("no images to stage")
    table = np.zeros((len(images), DESC_COLS), np.int64)
    off = 0
    for i, im in enumerate(images):
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"image {i}: want HWC uint8 RGB, got {im.dtype} "
                             f"{tuple(im.shape)}")
        h, w = im.shape[:2]
        if letterbox:
            rw, rh, xp, yp, _ = letterbox_params(w, h, dim, dim)
        else:
            rw, rh, xp, yp = dim, dim, 0, 0
        if rw < 1 or rh < 1:
            raise ValueError(f"image {i} ({w}x{h}) letterboxes to {rw}x{rh} at {dim}")
        table[i] = off, w, h, rw, rh, xp, yp
        off += h * w * 3
    return table


def stage_batch(images: Sequence[np.ndarray], dim: int, letterbox: bool, device):
    """Stage HWC uint8 RGB ``images`` for :func:`letterbox_batch` on
    ``device``: returns (src, desc, org), the packed image bytes (uint8
    [total]), the descriptor table (int64 [B, DESC_COLS]) and the sizes
    (float32 [B, 2], (w, h)).

    The three are uploaded as one uint8 block; for a card the block is
    pinned (PyTorch's caching host allocator, which holds a block until the
    copies that read it are done) and uploaded with one non-blocking copy,
    so staging never waits for the card.  ``src`` and ``desc`` are views of
    the block; ``org`` is a copy of its own, so that keeping it does not
    keep the batch's bytes."""
    device = torch.device(device)
    table = _descriptors(images, dim, letterbox)
    b = len(images)
    desc_bytes, org_bytes = b * DESC_COLS * 8, b * 2 * 4
    head = -(-(desc_bytes + org_bytes) // 64) * 64
    total = int(table[-1, 0] + table[-1, 1] * table[-1, 2] * 3)
    block = torch.empty(head + total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    packed = block.numpy()
    packed[:desc_bytes].view(np.int64)[:] = table.reshape(-1)
    packed[desc_bytes:desc_bytes + org_bytes].view(np.float32)[:] = table[:, 1:3].reshape(-1)
    # one plain copy an image on this thread: a copy split over the intra-op
    # threads waits for the slowest of them, which on a host shared with
    # other work stalls for tens of ms now and then
    for (off, w, h), im in zip(table[:, :3].tolist(), images):
        packed[head + off:head + off + h * w * 3] = im.reshape(-1)
    if device.type != "cpu":
        block = block.to(device, non_blocking=True)
    desc = block[:desc_bytes].view(torch.int64).view(b, DESC_COLS)
    org = block[desc_bytes:desc_bytes + org_bytes].view(torch.float32).view(b, 2).clone()
    return block[head:], desc, org


def letterbox_batch_ref(src: torch.Tensor, desc: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain version of :func:`letterbox_batch`: each image of the table
    resized on its own (a cubic resize as two matmuls), clamped to [0, 1]
    and placed on a 128/255 canvas."""
    out = torch.full((desc.shape[0], dim, dim, 3), PAD_VALUE, dtype=torch.float32,
                     device=src.device)
    for i, (off, w, h, rw, rh, xp, yp) in enumerate(desc.tolist()):
        img = src[off:off + h * w * 3].view(h, w, 3).to(torch.float32) / 255.0
        # cubic overshoot -> clip to gamut, like the reference's uint8 saturation
        out[i, yp:yp + rh, xp:xp + rw] = resize_cubic_device(img, rh, rw).clamp(0.0, 1.0)
    return out


def letterbox_batch(src: torch.Tensor, desc: torch.Tensor, dim: int) -> torch.Tensor:
    """Letterbox (or plainly resize) the staged batch (:func:`stage_batch`)
    to float32 [B, dim, dim, 3] in [0, 1], each image's geometry read from
    its row of ``desc``.  CUDA operands run ``csrc/letterbox.cu`` in one
    launch or raise; CPU ones run :func:`letterbox_batch_ref`.
    ``letterbox_batch.launches`` counts kernel launches."""
    if src.device.type == "cpu":
        return letterbox_batch_ref(src, desc, dim)
    out = _launch(src, desc, dim)
    letterbox_batch.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("letterbox")
    lib.yolo_letterbox_u8.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p]
    lib.yolo_letterbox_u8.restype = ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(src: torch.Tensor, desc: torch.Tensor, dim: int) -> torch.Tensor:
    """Check the operands of a CUDA launch and run the kernel."""
    if src.device.type != "cuda":
        raise ValueError(f"letterbox_batch: unsupported device {src.device}")
    if desc.device != src.device:
        raise ValueError("letterbox_batch: src and desc must be on one device")
    if src.dtype != torch.uint8 or src.dim() != 1:
        raise TypeError(f"letterbox_batch: src must be 1-D uint8, got {src.dtype} "
                        f"{tuple(src.shape)}")
    if desc.dtype != torch.int64 or desc.dim() != 2 or desc.shape[1] != DESC_COLS:
        raise TypeError(f"letterbox_batch: desc must be int64 [B, {DESC_COLS}], got "
                        f"{desc.dtype} {tuple(desc.shape)}")
    if not (src.is_contiguous() and desc.is_contiguous()):
        raise ValueError("letterbox_batch: operands must be contiguous")
    if not 1 <= desc.shape[0] <= 65535:
        raise ValueError(f"letterbox_batch: batch must be in 1..65535, got {desc.shape[0]}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"letterbox_batch: dim must be in 1..{MAX_DIM}, got {dim}")
    b = desc.shape[0]
    out = torch.empty((b, dim, dim, 3), dtype=torch.float32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        rc = lib.yolo_letterbox_u8(src.data_ptr(), src.numel(), desc.data_ptr(),
                                   out.data_ptr(), b, dim, PAD_VALUE,
                                   torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"letterbox kernel launch failed for {b} images at {dim}: "
                           f"{lib.yolo_cuda_error_string(rc).decode()}")
    return out


letterbox_batch.launches = 0


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
