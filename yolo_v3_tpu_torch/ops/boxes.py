"""Bounding-box geometry: conversions, IoU, letterbox math.

Port of ``yolo_v3_tpu/ops/boxes.py``.  Boxes are [..., 4] tensors; image
sizes may be Python numbers or tensors that broadcast against the box
columns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from yolo_v3_tpu_torch.utils.profiling import span


class CoordinateType:
    """Pixel-space vs. normalized coordinates."""

    Absolute = 0
    Relative = 1


class FormatType:
    """Box layouts."""

    x1y1x2y2 = 0  # corners
    cxcywh = 1    # center + size
    xywh = 2      # top-left + size (COCO)


# ---------------------------------------------------------------------------
# Format conversions.  All take [..., 4] and return [..., 4].
# ---------------------------------------------------------------------------

def x1y1x2y2_to_cxcywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    w, h = x2 - x1, y2 - y1
    return torch.stack([x1 + w / 2, y1 + h / 2, w, h], dim=-1)


def x1y1x2y2_to_xywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def cxcywh_to_x1y1x2y2(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def cxcywh_to_xywh(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, w, h], dim=-1)


def xywh_to_x1y1x2y2(box: torch.Tensor) -> torch.Tensor:
    x, y, w, h = box.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xywh_to_cxcywh(box: torch.Tensor) -> torch.Tensor:
    x, y, w, h = box.unbind(-1)
    return torch.stack([x + w / 2, y + h / 2, w, h], dim=-1)


_FORMAT_TABLE = {
    (FormatType.x1y1x2y2, FormatType.cxcywh): x1y1x2y2_to_cxcywh,
    (FormatType.x1y1x2y2, FormatType.xywh): x1y1x2y2_to_xywh,
    (FormatType.cxcywh, FormatType.x1y1x2y2): cxcywh_to_x1y1x2y2,
    (FormatType.cxcywh, FormatType.xywh): cxcywh_to_xywh,
    (FormatType.xywh, FormatType.x1y1x2y2): xywh_to_x1y1x2y2,
    (FormatType.xywh, FormatType.cxcywh): xywh_to_cxcywh,
}


def _wh_scale(box: torch.Tensor, img_dim: Tuple[int, int]) -> torch.Tensor:
    w, h = img_dim
    dtype = box.dtype if box.is_floating_point() else torch.float32
    return torch.tensor([w, h, w, h], dtype=dtype, device=box.device)


def absolute_to_relative(box: torch.Tensor, img_dim: Tuple[int, int]) -> torch.Tensor:
    """Divide x-like coords by the image width, y-like by its height;
    ``img_dim`` is (width, height).  Columns 0, 2 are x-like and 1, 3
    y-like in all three formats."""
    return box / _wh_scale(box, img_dim)


def relative_to_absolute(box: torch.Tensor, img_dim: Tuple[int, int]) -> torch.Tensor:
    return box * _wh_scale(box, img_dim)


def convert(
    labels: torch.Tensor,
    src_coord: int,
    src_format: int,
    dst_coord: int,
    dst_format: int,
    bbox_idx: Tuple[int, int, int, int] = (0, 1, 2, 3),
    img_dim: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Convert the 4 box columns at ``bbox_idx`` of ``labels`` between
    formats and coordinate types (out of place)."""
    labels = torch.as_tensor(labels)
    cols = list(bbox_idx)
    box = labels[..., cols]
    if src_format != dst_format:
        box = _FORMAT_TABLE[(src_format, dst_format)](box)
    if src_coord != dst_coord:
        if src_coord == CoordinateType.Absolute:
            box = absolute_to_relative(box, img_dim)
        else:
            box = relative_to_absolute(box, img_dim)
    out = labels.to(box.dtype).clone()
    out[..., cols] = box
    return out


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------

def _corners(box: torch.Tensor, mode: str):
    if mode == "x1y1x2y2":
        return box.unbind(-1)
    if mode == "cxcywh":
        cx, cy, w, h = box.unbind(-1)
        return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
    raise ValueError(f"unknown box mode {mode!r}")


def _iou(b1: torch.Tensor, b2: torch.Tensor, mode: str) -> torch.Tensor:
    """IoU of broadcasting boxes.  No epsilon: degenerate (zero-area) pairs
    give 0/0 = NaN, as in the reference."""
    b1_x1, b1_y1, b1_x2, b1_y2 = _corners(b1, mode)
    b2_x1, b2_y1, b2_x2, b2_y2 = _corners(b2, mode)
    ix1 = torch.maximum(b1_x1, b2_x1)
    iy1 = torch.maximum(b1_y1, b2_y1)
    ix2 = torch.minimum(b1_x2, b2_x2)
    iy2 = torch.minimum(b1_y2, b2_y2)
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area1 = (b1_x2 - b1_x1) * (b1_y2 - b1_y1)
    area2 = (b2_x2 - b2_x1) * (b2_y2 - b2_y1)
    return inter / (area1 + area2 - inter)


def iou_matrix(b1: torch.Tensor, b2: torch.Tensor, mode: str = "x1y1x2y2") -> torch.Tensor:
    """All-pairs IoU of ``b1`` [..., N, 4] and ``b2`` [..., M, 4] ->
    [..., N, M]."""
    return _iou(b1[..., :, None, :], b2[..., None, :, :], mode)


def iou_pairwise(b1: torch.Tensor, b2: torch.Tensor, mode: str = "x1y1x2y2") -> torch.Tensor:
    """Element-wise IoU of aligned boxes [..., 4] x [..., 4] -> [...]."""
    return _iou(b1, b2, mode)


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of co-centered boxes given sizes only: [..., N, 2] x [..., M, 2]
    -> [..., N, M] (best-anchor assignment)."""
    w1, h1 = wh1[..., :, None, 0], wh1[..., :, None, 1]
    w2, h2 = wh2[..., None, :, 0], wh2[..., None, :, 1]
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    return inter / (w1 * h1 + w2 * h2 - inter)


def letterbox_params(org_w: int, org_h: int, new_w: int, new_h: int):
    """Aspect-preserving resize-and-pad geometry with the reference's int
    truncation: returns (resize_w, resize_h, x_pad, y_pad, ratio)."""
    ratio = min(new_w / org_w, new_h / org_h)
    resize_w, resize_h = int(org_w * ratio), int(org_h * ratio)
    x_pad, y_pad = (new_w - resize_w) // 2, (new_h - resize_h) // 2
    return resize_w, resize_h, x_pad, y_pad, ratio


def _clip(v, hi):
    return torch.minimum(v.clamp(min=0), torch.as_tensor(hi, dtype=v.dtype,
                                                         device=v.device))


def _letterbox_geometry(like, org_w, org_h, new_w, new_h):
    """(ratio, resized w, resized h, x pad, y pad) as float32 tensors on
    ``like``'s device, floored as the reference does.  The new size is a
    number: on a card each of its two values is a blocking copy."""
    org_w, org_h = (torch.as_tensor(v, dtype=torch.float32, device=like.device)
                    for v in (org_w, org_h))
    with span("h2d"):
        new_w_ = torch.as_tensor(new_w, dtype=torch.float32, device=like.device)
    with span("h2d"):
        new_h_ = torch.as_tensor(new_h, dtype=torch.float32, device=like.device)
    # tensor / tensor: ``int / tensor`` multiplies by a rounded reciprocal,
    # which can move the floor below by one pixel
    ratio = torch.minimum(new_w_ / org_w, new_h_ / org_h)
    rw, rh = torch.floor(org_w * ratio), torch.floor(org_h * ratio)
    return ratio, rw, rh, torch.floor((new_w - rw) / 2), torch.floor((new_h - rh) / 2)


def letterbox_reverse(boxes: torch.Tensor, org_w, org_h, new_w, new_h) -> torch.Tensor:
    """Corner boxes in letterboxed pixels -> original-image pixels, clipped
    to the original frame.  float32 arithmetic, as in the JAX version."""
    org_w = torch.as_tensor(org_w, dtype=torch.float32, device=boxes.device)
    org_h = torch.as_tensor(org_h, dtype=torch.float32, device=boxes.device)
    ratio, _, _, x_pad, y_pad = _letterbox_geometry(boxes, org_w, org_h, new_w, new_h)
    x1 = _clip((boxes[..., 0] - x_pad) / ratio, org_w)
    y1 = _clip((boxes[..., 1] - y_pad) / ratio, org_h)
    x2 = _clip((boxes[..., 2] - x_pad) / ratio, org_w)
    y2 = _clip((boxes[..., 3] - y_pad) / ratio, org_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def rescale_boxes(boxes: torch.Tensor, org_w, org_h, new_w, new_h) -> torch.Tensor:
    """Undo a plain (non-aspect-preserving) resize."""
    org_w = torch.as_tensor(org_w, dtype=torch.float32, device=boxes.device)
    org_h = torch.as_tensor(org_h, dtype=torch.float32, device=boxes.device)
    rx, ry = new_w / org_w, new_h / org_h
    x1 = _clip(boxes[..., 0] / rx, org_w)
    y1 = _clip(boxes[..., 1] / ry, org_h)
    x2 = _clip(boxes[..., 2] / rx, org_w)
    y2 = _clip(boxes[..., 3] / ry, org_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _with_box_columns(labels, cx, cy, w, h):
    out = labels.clone()
    out[..., 1], out[..., 2], out[..., 3], out[..., 4] = cx, cy, w, h
    return out


def letterbox_labels(labels: torch.Tensor, org_w, org_h, new_w, new_h) -> torch.Tensor:
    """Relative-cxcywh label rows [..., >=5] (cls, cx, cy, w, h) from
    original-image space into letterboxed space."""
    labels = torch.as_tensor(labels, dtype=torch.float32)
    _, rw, rh, xp, yp = _letterbox_geometry(labels, org_w, org_h, new_w, new_h)
    return _with_box_columns(labels,
                             labels[..., 1] * (rw / new_w) + xp / new_w,
                             labels[..., 2] * (rh / new_h) + yp / new_h,
                             labels[..., 3] * (rw / new_w),
                             labels[..., 4] * (rh / new_h))


def letterbox_labels_reverse(labels: torch.Tensor, org_w, org_h, new_w, new_h) -> torch.Tensor:
    """Inverse of :func:`letterbox_labels`, clipped to [0, 1]."""
    labels = torch.as_tensor(labels, dtype=torch.float32)
    _, rw, rh, xp, yp = _letterbox_geometry(labels, org_w, org_h, new_w, new_h)
    return _with_box_columns(labels,
                             ((labels[..., 1] - xp / new_w) / (rw / new_w)).clamp(0, 1),
                             ((labels[..., 2] - yp / new_h) / (rh / new_h)).clamp(0, 1),
                             (labels[..., 3] / (rw / new_w)).clamp(0, 1),
                             (labels[..., 4] / (rh / new_h)).clamp(0, 1))


def correct_yolo_boxes(boxes: torch.Tensor, org_w, org_h, img_w, img_h,
                       is_letterbox: bool = False) -> torch.Tensor:
    """Network-input corners -> original-image xywh."""
    if is_letterbox:
        boxes = letterbox_reverse(boxes, org_w, org_h, img_w, img_h)
    else:
        boxes = rescale_boxes(boxes, org_w, org_h, img_w, img_h)
    return x1y1x2y2_to_xywh(boxes)
