"""COCO-style mAP@0.5 evaluation.

The port's own copy of ``yolo_v3_tpu/eval/cocoeval.py``.  The reference
scores with pycocotools' COCOeval (evaluate.ipynb cells 48-52);
:func:`evaluate_map` keeps it as the metric oracle where it imports and
otherwise scores with the faithful COCOeval reimplementation
:func:`yolo_v3_tpu_torch.eval.cocoeval_np.coco_ap`.  The simplified
evaluator :func:`average_precision_at_iou` implements the same protocol for
the bbox / AP@0.5 slice without crowds or ignores:

* detections sorted by score (stable), greedy-matched per (image, category)
  to the not-yet-matched GT with the highest IoU >= threshold,
* up to ``max_dets`` detections per image per category (COCO maxDets=100),
* AP = 101-point interpolated precision averaged over recall grid
  (COCOeval's accumulate), averaged over categories present in the GT.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

RECALL_GRID = np.linspace(0.0, 1.0, 101)


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] xywh IoU."""
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix1 = np.maximum(ax1[:, None], bx1)
    iy1 = np.maximum(ay1[:, None], by1)
    ix2 = np.minimum(ax2[:, None], bx2)
    iy2 = np.minimum(ay2[:, None], by2)
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = area_a[:, None] + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision_at_iou(
    gt_json: Dict,
    results: List[Dict],
    iou_thr: float = 0.5,
    max_dets: int = 100,
) -> Tuple[float, Dict[int, float]]:
    """(mAP, per-category AP) at a single IoU threshold."""
    gts = defaultdict(list)   # (img, cat) -> [bbox]
    n_gt_per_cat: Dict[int, int] = defaultdict(int)
    for ann in gt_json["annotations"]:
        gts[(ann["image_id"], ann["category_id"])].append(ann["bbox"])
        n_gt_per_cat[ann["category_id"]] += 1

    dts = defaultdict(list)   # (img, cat) -> [(score, bbox)]
    for det in results:
        dts[(det["image_id"], det["category_id"])].append(
            (float(det["score"]), det["bbox"])
        )

    cat_ids = sorted(n_gt_per_cat)
    ap_per_cat: Dict[int, float] = {}
    for cat in cat_ids:
        # gather matches across all images of this category
        scores: List[float] = []
        matched: List[bool] = []
        for (img, c), dlist in dts.items():
            if c != cat:
                continue
            dlist = sorted(dlist, key=lambda t: -t[0])[:max_dets]
            gt_boxes = np.asarray(gts.get((img, cat), []), np.float64).reshape(-1, 4)
            taken = np.zeros(len(gt_boxes), bool)
            if len(dlist):
                d_boxes = np.asarray([d[1] for d in dlist], np.float64)
                ious = _iou_xywh(d_boxes, gt_boxes) if len(gt_boxes) else None
            for di, (score, _) in enumerate(dlist):
                ok = False
                if len(gt_boxes):
                    order = np.argsort(-ious[di])
                    for gi in order:
                        if ious[di, gi] < iou_thr:
                            break
                        if not taken[gi]:
                            taken[gi] = True
                            ok = True
                            break
                scores.append(score)
                matched.append(ok)

        n_gt = n_gt_per_cat[cat]
        if n_gt == 0:
            continue
        if not scores:
            ap_per_cat[cat] = 0.0
            continue
        order = np.argsort(-np.asarray(scores), kind="stable")
        tp = np.asarray(matched)[order]
        fp = ~tp
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        # monotone precision envelope then 101-point interpolation (COCOeval)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        idx = np.searchsorted(recall, RECALL_GRID, side="left")
        prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
        ap_per_cat[cat] = float(np.mean(prec_at))

    mAP = float(np.mean(list(ap_per_cat.values()))) if ap_per_cat else 0.0
    return mAP, ap_per_cat


def evaluate_map(
    gt_json_path: str,
    results_json_path: str,
    iou_thr: float = 0.5,
    prefer_pycocotools: bool = True,
) -> float:
    """mAP@iou_thr from files; pycocotools when available (the reference's
    oracle, evaluate.ipynb cells 48-52), in-repo evaluator otherwise."""
    if prefer_pycocotools:
        try:
            from pycocotools.coco import COCO
            from pycocotools.cocoeval import COCOeval

            coco = COCO(gt_json_path)
            dets = coco.loadRes(results_json_path)
            ev = COCOeval(coco, dets, "bbox")
            ev.params.iouThrs = np.asarray([iou_thr])
            ev.evaluate()
            ev.accumulate()
            prec = ev.eval["precision"]  # [T, R, K, A, M]
            valid = prec[0, :, :, 0, -1]
            valid = valid[valid > -1]
            return float(np.mean(valid)) if valid.size else 0.0
        except ImportError:
            pass

    from yolo_v3_tpu_torch.eval.cocoeval_np import coco_ap

    with open(gt_json_path) as f:
        gt = json.load(f)
    with open(results_json_path) as f:
        results = json.load(f)
    mAP, _ = coco_ap(gt, results, iou_thr)
    return mAP
