"""Plain display-mode postprocess: raw heads -> detection rows.

Per scale, a cell-anchor's score is sigmoid(objectness) x sigmoid(its best
class logit), zero at or below ``conf``; each scale keeps its ``topk`` best
(ties to the lower index; rows in (h, w, anchor) order, channel a * (5 + C)
+ j).  A kept row decodes to (sigmoid(tx) + cx) * stride, exp(tw) x anchor,
its class is the argmax logit.  Class-wise greedy NMS over the union: in
score order (ties to the lower index), a box is dropped when a kept box of
its class overlaps it with IoU > ``nms``; the best ``max_det`` survive.
Boxes go back to original-image pixels through the letterbox's geometry
(ratio = min(S / w, S / h), resized size and pads floored), clipped to the
frame.  Rows: [cls, x, y, w, h, prob, obj].  Computed in float64, or in
bfloat16 (``dtype``) for the control.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def rows(heads: Sequence[torch.Tensor], org_wh: Sequence[Sequence[int]], anchors, masks,
         img_dim: int, conf: float, nms: float, topk: int, max_det: int,
         dtype=torch.float64) -> List[np.ndarray]:
    heads = [h.detach().to("cpu", dtype) for h in heads]
    out = []
    for b, (ow, oh) in enumerate(org_wh):
        boxes, score, cls, obj = [], [], [], []
        for raw, mask in zip(heads, masks):
            gh, gw = raw.shape[1], raw.shape[2]
            a_n = len(mask)
            r = raw[b].reshape(gh * gw * a_n, -1)
            s = torch.sigmoid(r[:, 4]) * torch.sigmoid(r[:, 5:].amax(dim=1))
            s = torch.where(s > conf, s, torch.zeros_like(s))
            order = torch.sort(s, descending=True, stable=True).indices[:min(topk, len(s))]
            sel = r[order]
            a = order % a_n
            cell = order // a_n
            stride = img_dim / gh
            aw = torch.tensor([anchors[m][0] for m in mask], dtype=dtype)[a]
            ah = torch.tensor([anchors[m][1] for m in mask], dtype=dtype)[a]
            bx = (torch.sigmoid(sel[:, 0]) + (cell % gw).to(dtype)) * stride
            by = (torch.sigmoid(sel[:, 1]) + (cell // gw).to(dtype)) * stride
            bw = torch.exp(sel[:, 2]) * aw
            bh = torch.exp(sel[:, 3]) * ah
            boxes.append(torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], 1))
            score.append(s[order])
            cls.append(torch.argmax(sel[:, 5:], dim=1))
            obj.append(torch.sigmoid(sel[:, 4]))
        boxes, score, cls, obj = (torch.cat(t) for t in (boxes, score, cls, obj))
        keep = _greedy_nms(boxes, score, cls, nms)[:max_det]
        bx = boxes[keep]
        ratio = min(img_dim / ow, img_dim / oh)
        rw, rh = np.floor(ow * ratio), np.floor(oh * ratio)
        xp, yp = np.floor((img_dim - rw) / 2), np.floor((img_dim - rh) / 2)
        x1 = ((bx[:, 0] - xp) / ratio).clamp(0, ow)
        y1 = ((bx[:, 1] - yp) / ratio).clamp(0, oh)
        x2 = ((bx[:, 2] - xp) / ratio).clamp(0, ow)
        y2 = ((bx[:, 3] - yp) / ratio).clamp(0, oh)
        out.append(torch.stack([cls[keep].to(dtype), x1, y1, x2 - x1, y2 - y1,
                                score[keep], obj[keep]], 1).double().numpy())
    return out


def _greedy_nms(boxes, score, cls, thr) -> List[int]:
    order = torch.sort(score, descending=True, stable=True).indices.tolist()
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    kept: List[int] = []
    for i in order:
        if score[i] <= 0:
            break
        if kept:
            k = torch.tensor(kept)
            same = cls[k] == cls[i]
            iw = (torch.minimum(boxes[k, 2], boxes[i, 2])
                  - torch.maximum(boxes[k, 0], boxes[i, 0])).clamp(min=0)
            ih = (torch.minimum(boxes[k, 3], boxes[i, 3])
                  - torch.maximum(boxes[k, 1], boxes[i, 1])).clamp(min=0)
            inter = iw * ih
            iou = inter / (area[k] + area[i] - inter)
            if bool((same & (iou > thr)).any()):
                continue
        kept.append(i)
    return kept


def unmatched(a: np.ndarray, b: np.ndarray, box_tol: float, prob_tol: float) -> int:
    """Rows of ``a`` without a row of ``b`` of the same class, box within
    ``box_tol`` px and prob / obj within ``prob_tol`` (each row of ``b``
    taken once)."""
    used = np.zeros(len(b), bool)
    n = 0
    for row in a:
        ok = ((b[:, 0] == row[0]) & ~used
              & (np.abs(b[:, 1:5] - row[1:5]).max(1, initial=0) <= box_tol)
              & (np.abs(b[:, 5:] - row[5:]).max(1, initial=0) <= prob_tol))
        if ok.any():
            used[np.argmax(ok)] = True
        else:
            n += 1
    return n
