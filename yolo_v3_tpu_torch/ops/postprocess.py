"""Detection postprocessing on the device: thresholding + class-wise greedy
NMS, in fixed shapes.

Port of the display (serving) path of ``yolo_v3_tpu/ops/postprocess.py``:
``nms_fixed``, ``_postprocess_fast_display`` and ``detections_to_lists``.
Output rows are [B, M, 8]: (x1, y1, x2, y2, obj, prob, cls, valid), invalid
rows zeroed.

Ties: the JAX code ranks with ``jax.lax.top_k``, which puts equal scores in
index order.  ``torch.topk`` promises no order among ties, so every ranking
here is a stable descending sort, which does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from yolo_v3_tpu_torch.ops import boxes as B

# Larger than any supported input dimension (608) so class-offset boxes of
# distinct classes can never intersect.
_CLASS_OFFSET = 8192.0


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim, equal values in index order (the
    ``jax.lax.top_k`` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_fixed(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    nms_thr: float,
    max_detections: int,
    presorted: bool = True,
):
    """Exact greedy NMS over K fixed candidates, batched over leading dims.

    ``boxes_xyxy`` [..., K, 4] (class-offset if class-wise), ``scores``
    [..., K] with invalid candidates at 0.  ``presorted=False`` ranks by the
    priority relation (higher score wins, ties to the lower index) instead
    of index order.  Iterates ``keep[i] = valid[i] and no higher-priority
    kept j overlaps i`` from all-kept to its fixpoint, which is the greedy
    solution.  Returns (indices [..., M] int64, valid [..., M] bool) in
    descending score order.
    """
    k = scores.shape[-1]
    valid = scores > 0.0
    iou = B.iou_matrix(boxes_xyxy, boxes_xyxy)
    idx = torch.arange(k, device=scores.device)
    lower_idx = idx[:, None] < idx[None, :]        # j < i pairs (j rows)
    if presorted:
        upper = lower_idx
    else:
        s_j, s_i = scores[..., :, None], scores[..., None, :]
        upper = (s_j > s_i) | ((s_j == s_i) & lower_idx)
    overlap = upper & (iou > nms_thr)              # j suppresses i

    keep = valid
    for _ in range(k):
        suppressed = (overlap & keep[..., :, None]).any(dim=-2)
        new_keep = valid & ~suppressed
        done = torch.equal(new_keep, keep)
        keep = new_keep
        if done:
            break

    masked = torch.where(keep, scores, torch.zeros_like(scores))
    m_eff = min(max_detections, k)
    top_scores, out_idx = _top_k(masked, m_eff)
    if m_eff < max_detections:
        pad = list(scores.shape[:-1]) + [max_detections - m_eff]
        top_scores = torch.cat([top_scores, top_scores.new_zeros(pad)], dim=-1)
        out_idx = torch.cat([out_idx, out_idx.new_zeros(pad)], dim=-1)
    return out_idx, top_scores > 0.0


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...], idx [B, M] -> [B, M, ...]."""
    ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, ix)


def _postprocess_fast_display(raws, config, img_dim, conf_thr, nms_thr,
                              use_nms: bool, per_scale_k: int) -> torch.Tensor:
    """Display-mode postprocess with per-scale candidate selection: each
    scale's top ``per_scale_k`` rows by score (argmax class prob x obj, 0
    below ``conf_thr``), decoded, then class-wise greedy NMS over their union.
    ``raws`` are NHWC raw heads, coarse first."""
    C = config.num_classes
    attrib = 5 + C
    A = config.anchors_per_scale
    m = config.max_detections

    boxes_l, score_l, cls_l, obj_l = [], [], [], []
    for raw, mask in zip(raws, config.anchor_masks):
        b, h, w, _ = raw.shape
        stride = img_dim / h
        dev = raw.device
        aw_c = torch.tensor([config.anchors[i][0] for i in mask],
                            dtype=torch.float32, device=dev)
        ah_c = torch.tensor([config.anchors[i][1] for i in mask],
                            dtype=torch.float32, device=dev)
        rows_all = raw.reshape(b, h * w * A, attrib)   # rows in (h, w, a) order
        o = rows_all[..., 4].float()
        cmx = rows_all[..., 5:].float().amax(dim=-1)
        s = torch.sigmoid(o) * torch.sigmoid(cmx)
        s = torch.where(s > conf_thr, s, torch.zeros_like(s))

        k_s = min(per_scale_k, s.shape[1])
        top_s, top_i = _top_k(s, k_s)
        row = _gather_rows(rows_all, top_i).float()    # [B, k_s, attrib]

        a_i = top_i % A
        cell = top_i // A
        gx = (cell % w).float()
        gy = (cell // w).float()
        bx = (torch.sigmoid(row[..., 0]) + gx) * stride
        by = (torch.sigmoid(row[..., 1]) + gy) * stride
        bw = torch.exp(row[..., 2]) * aw_c[a_i]
        bh = torch.exp(row[..., 3]) * ah_c[a_i]
        boxes_l.append(torch.stack(
            [bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], dim=-1))
        score_l.append(top_s)
        cls_l.append(torch.argmax(row[..., 5:], dim=-1).float())
        obj_l.append(torch.sigmoid(row[..., 4]))

    boxes = torch.cat(boxes_l, dim=1)                  # [B, K, 4]
    score = torch.cat(score_l, dim=1)
    cls = torch.cat(cls_l, dim=1)
    obj = torch.cat(obj_l, dim=1)
    k = score.shape[1]

    if use_nms:
        # order-free NMS: the priority mask replaces the global sort
        shifted = boxes + (cls * _CLASS_OFFSET)[..., None]
        sel, valid = nms_fixed(shifted, score, nms_thr, m, presorted=False)
    else:
        # the first M rows must be the best M: sort the (small) merged set
        score, perm = _top_k(score, k)
        boxes, cls, obj = (_gather_rows(t, perm) for t in (boxes, cls, obj))
        m_eff = min(m, k)
        sel = torch.arange(m_eff, device=score.device).expand(score.shape[0], m_eff)
        valid = score[:, :m_eff] > 0.0
        if m_eff < m:
            pad = (score.shape[0], m - m_eff)
            sel = torch.cat([sel, sel.new_zeros(pad)], dim=1)
            valid = torch.cat([valid, valid.new_zeros(pad)], dim=1)

    out = torch.cat([
        _gather_rows(boxes, sel),
        _gather_rows(obj, sel)[..., None],
        _gather_rows(score, sel)[..., None],
        _gather_rows(cls, sel)[..., None],
        valid.float()[..., None],
    ], dim=-1)
    return out * valid.float()[..., None]


def postprocess_from_raws(raws, config, img_dim: int, conf_thr: float,
                          nms_thr: float, is_eval: bool = False,
                          use_nms: bool = True) -> torch.Tensor:
    """Raw NHWC heads -> [B, M, 8] detection rows in input-image pixels
    (display mode)."""
    if is_eval:
        raise NotImplementedError(
            "eval-mode postprocess (exact grid NMS over every (box, class) "
            "pair) is not ported yet: ROADMAP queue A, item 8")
    if config.display_per_scale_topk <= 0:
        raise NotImplementedError(
            "display_per_scale_topk=0 (global top-k display path and "
            "_nms_auto) is not ported yet: see ROADMAP 'Deferred pieces'")
    return _postprocess_fast_display(
        raws, config, img_dim, conf_thr, nms_thr, use_nms,
        config.display_per_scale_topk)


def detections_to_lists(results) -> List[np.ndarray]:
    """[B, M, 8] -> per-image [n_i, 7] numpy arrays
    (x1, y1, x2, y2, obj, prob, cls)."""
    results = results.detach().cpu().numpy() if torch.is_tensor(results) \
        else np.asarray(results)
    return [row[row[:, 7] > 0.5, :7] for row in results]
