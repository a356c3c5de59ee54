"""Faithful numpy reimplementation of the COCOeval bbox AP protocol.

The port's own copy of ``yolo_v3_tpu/eval/cocoeval_np.py``.  It is the
scorer :func:`yolo_v3_tpu_torch.eval.cocoeval.evaluate_map` uses where
pycocotools does not import, and an independent second scorer beside the
simplified greedy matcher of ``cocoeval.average_precision_at_iou``.  It
implements the published COCOeval algorithm for the bbox / single-IoU /
area=all slice, including the semantics the simple scorer does not model:

* crowd ground truths (``iscrowd``): IoU against a crowd is intersection
  over the DETECTION's area, crowds can absorb any number of detections,
  and a detection matched to a crowd is IGNORED (neither TP nor FP),
* explicit ``ignore`` ground truths (same ignore propagation),
* pycocotools' exact match loop: detections in score order (stable
  mergesort) each take the highest-IoU ground truth with IoU strictly
  improving over the threshold, preferring non-ignored GTs (ignored GTs are
  only considered once every non-ignored one is matched),
* per-(image, category) maxDets truncation BEFORE the global score sort,
* the 101-point precision envelope via ``searchsorted`` on the recall
  curve, zeros past the last recall point, and category AP of -1 (excluded
  from the mean) when the category has no non-ignored ground truth.

Implemented from the COCO evaluation protocol specification (the de-facto
standard published with the COCO dataset); no pycocotools code is used.
``tests/test_torch_eval.py`` holds it equal to the JAX package's copy.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

RECALL_GRID = np.linspace(0.0, 1.0, 101)


def _iou_bbox(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """[D,4] x [G,4] xywh IoU; crowd columns use intersection / dt area."""
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1)
    iy1 = np.maximum(dy1[:, None], gy1)
    ix2 = np.minimum(dx2[:, None], gx2)
    iy2 = np.minimum(dy2[:, None], gy2)
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = (dt[:, 2] * dt[:, 3])[:, None]
    area_g = gt[:, 2] * gt[:, 3]
    union = np.where(crowd[None, :], area_d,
                     area_d + area_g[None, :] - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_img(dts, gts, iou_thr, max_dets):
    """One (image, category) cell -> (dt_scores, dt_matched, dt_ignored,
    n_nonignored_gt), with detections already maxDets-truncated in score
    order."""
    g_ign = np.asarray(
        [bool(g.get("ignore")) or bool(g.get("iscrowd")) for g in gts],
        dtype=bool)
    crowd = np.asarray([bool(g.get("iscrowd")) for g in gts], dtype=bool)
    # non-ignored GTs first, original order preserved (mergesort = stable)
    gtind = np.argsort(g_ign, kind="mergesort")
    scores = np.asarray([d[0] for d in dts], np.float64)
    dtind = np.argsort(-scores, kind="mergesort")[:max_dets]

    n_gt = len(gts)
    npig = int((~g_ign).sum())
    if not len(dtind):
        return (np.zeros(0), np.zeros(0, bool), np.zeros(0, bool), npig)

    d_boxes = np.asarray([dts[i][1] for i in dtind], np.float64).reshape(-1, 4)
    if n_gt:
        g_boxes = np.asarray([g["bbox"] for g in gts],
                             np.float64).reshape(-1, 4)
        ious = _iou_bbox(d_boxes, g_boxes, crowd)
    gtm = np.full(n_gt, -1)
    dtm = np.full(len(dtind), -1)
    dt_ig = np.zeros(len(dtind), bool)
    for di in range(len(dtind)):
        if not n_gt:
            break
        best = min(iou_thr, 1 - 1e-10)
        m = -1
        for gi in gtind:
            # already matched non-crowd GTs are consumed
            if gtm[gi] >= 0 and not crowd[gi]:
                continue
            # non-ignored GTs are exhausted and a match exists: stop
            # before settling for an ignored one
            if m > -1 and not g_ign[m] and g_ign[gi]:
                break
            if ious[di, gi] < best:
                continue
            best = ious[di, gi]
            m = gi
        if m == -1:
            continue
        dtm[di] = m
        gtm[m] = di
        dt_ig[di] = g_ign[m]
    return (scores[dtind], dtm >= 0, dt_ig, npig)


def coco_ap(
    gt_json: Dict,
    results: List[Dict],
    iou_thr: float = 0.5,
    max_dets: int = 100,
) -> Tuple[float, Dict[int, float]]:
    """(mAP, per-category AP) at one IoU threshold, COCOeval protocol.

    Categories with no non-ignored ground truth are excluded from the mean
    (pycocotools' precision == -1 convention)."""
    gts = defaultdict(list)
    cats = set()
    for ann in gt_json["annotations"]:
        gts[(ann["image_id"], ann["category_id"])].append(ann)
        cats.add(ann["category_id"])
    dts = defaultdict(list)
    for det in results:
        dts[(det["image_id"], det["category_id"])].append(
            (float(det["score"]), det["bbox"]))
        cats.add(det["category_id"])
    img_ids = sorted({i for i, _ in gts} | {i for i, _ in dts})

    ap_per_cat: Dict[int, float] = {}
    for cat in sorted(cats):
        all_scores, all_tp, all_ig = [], [], []
        npig = 0
        for img in img_ids:
            s, matched, ig, n = _evaluate_img(
                dts.get((img, cat), []), gts.get((img, cat), []),
                iou_thr, max_dets)
            all_scores.append(s)
            all_tp.append(matched)
            all_ig.append(ig)
            npig += n
        if npig == 0:
            continue  # precision -1: excluded from the mean
        scores = np.concatenate(all_scores)
        order = np.argsort(-scores, kind="mergesort")
        tp = np.concatenate(all_tp)[order]
        ig = np.concatenate(all_ig)[order]
        tps = np.cumsum(tp & ~ig)
        fps = np.cumsum(~tp & ~ig)
        rc = tps / npig
        pr = tps / np.maximum(tps + fps, np.spacing(1))
        q = np.zeros(len(RECALL_GRID))
        # monotone envelope (in place, backwards) then recall-grid lookup
        pr = pr.tolist()
        for i in range(len(pr) - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds = np.searchsorted(rc, RECALL_GRID, side="left")
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        ap_per_cat[cat] = float(np.mean(q))

    mAP = float(np.mean(list(ap_per_cat.values()))) if ap_per_cat else 0.0
    return mAP, ap_per_cat


def evaluate_map_np(gt_json_path: str, results_json_path: str,
                    iou_thr: float = 0.5) -> float:
    with open(gt_json_path) as f:
        gt = json.load(f)
    with open(results_json_path) as f:
        results = json.load(f)
    return coco_ap(gt, results, iou_thr)[0]
