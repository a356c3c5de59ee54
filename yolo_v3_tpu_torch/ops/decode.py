"""YOLO head decode: raw conv output -> boxes, objectness and class
probabilities.  Port of ``yolo_v3_tpu/ops/decode.py``.

Decode math (per anchor, in grid units, then scaled by the stride)::

    bx = sigmoid(tx) + cx          bw = exp(tw) * anchor_w / stride
    by = sigmoid(ty) + cy          bh = exp(th) * anchor_h / stride
    conf = sigmoid(to)             cls = sigmoid(tc)

A head with a ``scale_x_y`` s (YOLOv4's: 1.05, 1.1, 1.2 from coarse to
fine) takes ``sigmoid(t) * s - (s - 1) / 2`` in place of ``sigmoid(t)``
(darknet's yolo layer); without one (``None``, YOLOv3) the decode is the
one above, operation for operation.

The fused postprocess (``ops/postprocess.py::postprocess_from_raws``) never
materializes these rows; :func:`decode_all` followed by
``postprocess`` is its oracle.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["decode_head", "decode_all", "raw_to_predictions", "xy_offset"]


def raw_to_predictions(raw: torch.Tensor, num_anchors: int, bbox_attrib: int) -> torch.Tensor:
    """[B, H, W, A*attrib] -> [B, H, W, A, attrib] (channel a * attrib + j)."""
    b, h, w, _ = raw.shape
    return raw.reshape(b, h, w, num_anchors, bbox_attrib)


def xy_offset(t: torch.Tensor, scale_x_y: Optional[float] = None) -> torch.Tensor:
    """A box centre's offset in its cell from the raw ``t``: ``sigmoid(t)``,
    or ``sigmoid(t) * s - (s - 1) / 2`` for a head's ``scale_x_y`` s."""
    if scale_x_y is None:
        return torch.sigmoid(t)
    return torch.sigmoid(t) * scale_x_y - (scale_x_y - 1) / 2


def decode_head(raw: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                stride: float, flatten: bool = True,
                scale_x_y: Optional[float] = None) -> torch.Tensor:
    """Decode one scale.  ``anchors`` are this scale's anchors in input-image
    pixels; ``stride`` is input_dim / grid_dim; ``scale_x_y`` the head's
    (module docstring), or None.

    Returns [B, H*W*A, 5+C] (``flatten``; rows in (h, w, a) order) or
    [B, H, W, A, 5+C], boxes cxcywh in input-image pixels, float32.
    """
    n_a = len(anchors)
    b, h, w, c = raw.shape
    attrib = c // n_a
    p = raw_to_predictions(raw.float(), n_a, attrib)
    dev = raw.device
    cx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    cy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    # anchors in grid units, as the reference divides them
    aw = torch.tensor([a[0] for a in anchors], dtype=torch.float32, device=dev) / stride
    ah = torch.tensor([a[1] for a in anchors], dtype=torch.float32, device=dev) / stride

    bx = (xy_offset(p[..., 0], scale_x_y) + cx) * stride
    by = (xy_offset(p[..., 1], scale_x_y) + cy) * stride
    bw = torch.exp(p[..., 2]) * aw * stride
    bh = torch.exp(p[..., 3]) * ah * stride
    conf = torch.sigmoid(p[..., 4])
    cls = torch.sigmoid(p[..., 5:])
    out = torch.cat([torch.stack([bx, by, bw, bh, conf], dim=-1), cls], dim=-1)
    return out.reshape(b, h * w * n_a, attrib) if flatten else out


def decode_all(raws: Sequence[torch.Tensor], config, img_dim: int,
               scale_x_y: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Decode every scale and concatenate -> [B, sum(H*W*A), 5+C];
    ``scale_x_y``: one per head, in the heads' order, or None."""
    outs = []
    for j, (raw, mask) in enumerate(zip(raws, config.anchor_masks)):
        stride = img_dim / raw.shape[1]
        outs.append(decode_head(raw, [config.anchors[i] for i in mask], stride,
                                scale_x_y=None if scale_x_y is None else scale_x_y[j]))
    return torch.cat(outs, dim=1)
