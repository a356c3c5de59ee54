"""Bounding-box geometry: conversions, IoU, letterbox math.

Port of the serving subset of ``yolo_v3_tpu/ops/boxes.py``.  Boxes are
[..., 4] tensors; image sizes may be Python numbers or tensors that
broadcast against the box columns.
"""

from __future__ import annotations

import torch


def x1y1x2y2_to_xywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def cxcywh_to_x1y1x2y2(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def iou_matrix(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU of corner boxes ``b1`` [..., N, 4] and ``b2`` [..., M, 4]
    -> [..., N, M].  No epsilon: degenerate (zero-area) pairs give 0/0 = NaN,
    as in the reference."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area1 = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area2 = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area1 + area2 - inter)


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


def letterbox_reverse(boxes: torch.Tensor, org_w, org_h, new_w, new_h) -> torch.Tensor:
    """Corner boxes in letterboxed pixels -> original-image pixels, clipped
    to the original frame.  float32 arithmetic, as in the JAX version."""
    org_w = torch.as_tensor(org_w, dtype=torch.float32, device=boxes.device)
    org_h = torch.as_tensor(org_h, dtype=torch.float32, device=boxes.device)
    ratio = torch.minimum(new_w / org_w, new_h / org_h)
    resize_w = torch.floor(org_w * ratio)
    resize_h = torch.floor(org_h * ratio)
    x_pad = torch.floor((new_w - resize_w) / 2)
    y_pad = torch.floor((new_h - resize_h) / 2)
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


def correct_yolo_boxes(boxes: torch.Tensor, org_w, org_h, img_w, img_h,
                       is_letterbox: bool = False) -> torch.Tensor:
    """Network-input corners -> original-image xywh."""
    if is_letterbox:
        boxes = letterbox_reverse(boxes, org_w, org_h, img_w, img_h)
    else:
        boxes = rescale_boxes(boxes, org_w, org_h, img_w, img_h)
    return x1y1x2y2_to_xywh(boxes)
