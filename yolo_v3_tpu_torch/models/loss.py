"""YOLOv3 training loss: target construction + masked MSE/BCE terms.

Port of ``yolo_v3_tpu/models/loss.py``, with the same semantics:

* labels are the *prefix* of non-zero rows: rows after the first all-zero
  row are ignored even if non-zero;
* the noobj mask is zeroed where ANY predicted box overlaps a valid GT with
  IoU > ignore_thres, so an assigned cell can still carry a noobj term;
* the best anchor is the argmax wh-IoU over all 9 anchors, and a GT trains
  a cell only in the scale that owns that anchor;
* a later GT overwrites an earlier one at the same (anchor, cell);
* the masked BCE multiplies predictions by the mask *before* the BCE, so
  masked-out cells give BCE(0, 0) = 0 and no gradient;
* every reduction is a sum (so accumulating subdivisions equals one large
  batch), and the stats are divided by the batch size;
* the coordinate weight sqrt(2 - w*h) boosts small objects.

The targets of a whole batch are built at once (no loop over images).  "Last
GT wins" is one deterministic scatter-max of (slot + 1) per cell, and the
winner's values are gathered by index, so they are copied exactly.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from yolo_v3_tpu_torch.ops import boxes as B
from yolo_v3_tpu_torch.ops.decode import raw_to_predictions
from yolo_v3_tpu_torch.utils.config import YoloConfig

STAT_KEYS = (
    "loss", "loss_x", "loss_y", "loss_w", "loss_h", "loss_conf", "loss_cls",
    "nCorrect", "nGT", "recall",
)


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log clamped at -100 (torch.nn.BCELoss semantics), written so the
    x == 0 branch takes a constant: a bare ``maximum(log(0), -100)`` gives
    NaN gradients (inf * 0)."""
    pos = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.clamp(torch.log(pos), min=-100.0), -100.0)


def _bce_elem(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Element-wise binary cross-entropy with clamped logs."""
    return -(target * _safe_log(pred) + (1.0 - target) * _safe_log(1.0 - pred))


def build_targets(
    pred_boxes: torch.Tensor,   # [B, A, H, W, 4] decoded boxes, grid units (detached)
    labels: torch.Tensor,       # [B, T, 5] rows (cls, cx, cy, w, h) relative
    anchors_all: torch.Tensor,  # [9, 2] grid units
    anchor_mask: Tuple[int, ...],
    num_classes: int,
    ignore_thres: float,
):
    """A batch's target tensors (the JAX ``build_targets_single`` over every
    image at once).  Returns (targets, noobj mask [B, A, H, W], nCorrect
    [B], nGT [B])."""
    nB, nA, nH, nW = pred_boxes.shape[:4]
    T = labels.shape[1]
    dev = labels.device

    # prefix-of-nonzero-rows validity (the reference's `break`)
    nonzero = labels.sum(dim=2) != 0
    valid = torch.cumprod(nonzero.to(torch.int32), dim=1) == 1

    gcls = labels[..., 0].to(torch.int64)
    gx = labels[..., 1] * nW
    gy = labels[..., 2] * nH
    gw = labels[..., 3] * nW
    gh = labels[..., 4] * nH
    gi = gx.to(torch.int64).clamp(0, nW - 1)
    gj = gy.to(torch.int64).clamp(0, nH - 1)

    # ---- noobj ignore mask: any pred box overlapping any valid GT --------
    gt_boxes = torch.stack([gx, gy, gw, gh], dim=-1)                     # [B, T, 4]
    ious = B.iou_matrix(pred_boxes.reshape(nB, -1, 4), gt_boxes, mode="cxcywh")
    ious = torch.nan_to_num(torch.where(valid[:, None, :], ious, 0.0), nan=0.0)
    ignore = (ious > ignore_thres).any(dim=2).reshape(nB, nA, nH, nW)
    noobj_mask = torch.where(ignore, 0.0, 1.0)

    # ---- best anchor over ALL 9, owned by this scale ---------------------
    anchor_iou = torch.nan_to_num(B.wh_iou(torch.stack([gw, gh], dim=-1), anchors_all),
                                  nan=0.0)                               # [B, T, 9]
    best_anchor = torch.argmax(anchor_iou, dim=2)                        # first max
    mask_arr = torch.tensor(anchor_mask, dtype=torch.int64, device=dev)
    hits = best_anchor[..., None] == mask_arr                            # [B, T, A]
    owned = hits.any(dim=2)
    local_a = torch.argmax(hits.to(torch.int32), dim=2)                  # 0 where none
    write = valid & owned

    anchors_scale = anchors_all[mask_arr]                                # [A, 2]
    t_x = gx - gi.to(gx.dtype)
    t_y = gy - gj.to(gy.dtype)
    t_w = torch.log(gw / anchors_scale[local_a, 0] + 1e-16)
    t_h = torch.log(gh / anchors_scale[local_a, 1] + 1e-16)
    coord_w = torch.sqrt(2.0 - labels[..., 3] * labels[..., 4])

    # per-GT correctness: IoU of the assigned cell's pred box vs this GT
    b_idx = torch.arange(nB, device=dev)[:, None]
    cell_pred = pred_boxes[b_idx, local_a, gj, gi]                       # [B, T, 4]
    cell_iou = torch.nan_to_num(B.iou_pairwise(cell_pred, gt_boxes, mode="cxcywh"),
                                nan=0.0)
    n_correct = (write & (cell_iou > 0.5)).to(torch.float32).sum(dim=1)
    n_gt = write.to(torch.float32).sum(dim=1)

    # ---- 'last GT wins': the writer with the highest slot wins its cell --
    cell = local_a * (nH * nW) + gj * nW + gi                            # [B, T]
    slot = (torch.arange(T, device=dev) + 1) * write.to(torch.int64)
    winner = torch.zeros(nB, nA * nH * nW, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(1, cell, slot, "amax")
    has = winner > 0
    classes = torch.arange(num_classes, device=dev)
    vals = torch.cat([torch.stack([coord_w, t_x, t_y, t_w, t_h], dim=-1),
                      (gcls[..., None] == classes).to(torch.float32)], dim=-1)
    idx = (winner - 1).clamp(min=0)[..., None].expand(-1, -1, vals.shape[-1])
    gathered = torch.where(has[..., None], torch.gather(vals, 1, idx), 0.0)
    gathered = gathered.reshape(nB, nA, nH, nW, 5 + num_classes)

    has = has.to(torch.float32).reshape(nB, nA, nH, nW)
    tgt = {
        "obj": has,
        "coord": gathered[..., 0],
        "tconf": has,
        "tx": gathered[..., 1],
        "ty": gathered[..., 2],
        "tw": gathered[..., 3],
        "th": gathered[..., 4],
        "tcls": gathered[..., 5:],
    }
    return tgt, noobj_mask, n_correct, n_gt


def yolo_layer_loss(
    raw: torch.Tensor,          # [B, H, W, A*(5+C)]
    labels: torch.Tensor,       # [B, T, 5]
    config: YoloConfig,
    anchor_mask: Tuple[int, ...],
    img_dim: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One scale's summed loss and its stats (losses divided by the batch
    size, counts summed)."""
    nB, nH, nW = raw.shape[0], raw.shape[1], raw.shape[2]
    nA = len(anchor_mask)
    stride = img_dim / nH
    C = config.num_classes
    dev = raw.device

    p = raw_to_predictions(raw.float(), nA, 5 + C)
    p = p.permute(0, 3, 1, 2, 4)                   # [B, A, H, W, .]

    preds_xy = torch.sigmoid(p[..., 0:2])
    preds_wh = p[..., 2:4]
    preds_conf = torch.sigmoid(p[..., 4])
    preds_cls = torch.sigmoid(p[..., 5:])

    # decoded boxes in grid units, gradient-detached
    cx = torch.arange(nW, dtype=torch.float32, device=dev)
    cy = torch.arange(nH, dtype=torch.float32, device=dev)[:, None]
    anchors_all = torch.tensor(config.anchors, dtype=torch.float32, device=dev) / stride
    anchors_scale = anchors_all[list(anchor_mask)]
    with torch.no_grad():
        pred_boxes = torch.stack(
            [preds_xy[..., 0] + cx,
             preds_xy[..., 1] + cy,
             torch.exp(preds_wh[..., 0]) * anchors_scale[None, :, None, None, 0],
             torch.exp(preds_wh[..., 1]) * anchors_scale[None, :, None, None, 1]],
            dim=-1)

    tgt, noobj_mask, n_correct, n_gt = build_targets(
        pred_boxes, labels.float(), anchors_all, anchor_mask, C, config.ignore_thres)
    obj_mask = tgt["obj"]
    coord = tgt["coord"]

    def mse_half(pred, target):
        return torch.sum((pred * coord - target * coord) ** 2) / 2.0

    loss_x = config.lambda_xy * mse_half(preds_xy[..., 0], tgt["tx"])
    loss_y = config.lambda_xy * mse_half(preds_xy[..., 1], tgt["ty"])
    loss_w = config.lambda_wh * mse_half(preds_wh[..., 0], tgt["tw"])
    loss_h = config.lambda_wh * mse_half(preds_wh[..., 1], tgt["th"])

    loss_conf = config.lambda_conf * (
        config.obj_scale * torch.sum(_bce_elem(preds_conf * obj_mask, obj_mask))
        + config.noobj_scale * torch.sum(_bce_elem(preds_conf * noobj_mask,
                                                   torch.zeros_like(noobj_mask))))
    # class BCE only over assigned cells: mask * bce == select
    loss_cls = config.lambda_cls * torch.sum(
        obj_mask[..., None] * _bce_elem(preds_cls, tgt["tcls"]))

    loss = loss_x + loss_y + loss_w + loss_h + loss_conf + loss_cls
    stats = {
        "loss": loss / nB,
        "loss_x": loss_x / nB,
        "loss_y": loss_y / nB,
        "loss_w": loss_w / nB,
        "loss_h": loss_h / nB,
        "loss_conf": loss_conf / nB,
        "loss_cls": loss_cls / nB,
        "nCorrect": n_correct.sum(),
        "nGT": n_gt.sum(),
    }
    return loss, stats


def yolo_loss(
    raws: Sequence[torch.Tensor],
    labels: torch.Tensor,
    config: YoloConfig,
    img_dim: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over all scales and the summed stats, with recall =
    nCorrect / nGT (0 without GTs)."""
    total = 0.0
    stats: Dict[str, torch.Tensor] = {}
    for raw, mask in zip(raws, config.anchor_masks):
        loss, s = yolo_layer_loss(raw, labels, config, mask, img_dim)
        total = total + loss
        for k, v in s.items():
            stats[k] = stats.get(k, 0.0) + v
    stats["recall"] = torch.where(
        stats["nGT"] > 0, stats["nCorrect"] / torch.clamp(stats["nGT"], min=1.0), 0.0)
    return total, stats
