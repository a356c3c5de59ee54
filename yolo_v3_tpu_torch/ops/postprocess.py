"""Detection postprocessing on the device: thresholding + class-wise greedy
NMS, in fixed shapes.

Port of ``yolo_v3_tpu/ops/postprocess.py``:

* the decoded-rows path :func:`postprocess` (rows of ``ops/decode.py``'s
  ``decode_all``), in display and eval mode;
* the fused path :func:`postprocess_from_raws` on the raw heads: the
  per-scale display path (``display_per_scale_topk > 0``, the default), the
  global-top-k display path (``display_per_scale_topk <= 0``) and eval mode,
  which runs :func:`nms_pairs_grid` (exact greedy NMS over every (box,
  class) pair above the threshold, the JAX default ``eval_grid_nms``);
* :func:`nms_fixed`, the one NMS of both display paths and of the
  decoded-rows path.

Semantics: a detection's probability is class prob x objectness; display
mode proposes each box's argmax class, eval mode every (box, class) pair;
NMS is greedy in score order within each class (boxes shifted by
``class * _CLASS_OFFSET`` never overlap across classes).

Output rows are [B, M, 8]: (x1, y1, x2, y2, obj, prob, cls, valid), invalid
rows zeroed.

Every decode of the raw heads takes an optional ``scale_x_y``, one per head
in the heads' order (YOLOv4's; ``ops/decode.py::xy_offset``); without it
(None, YOLOv3) each path decodes as it did, operation for operation.

Not ported (ROADMAP's do-not-port list): ``nms_blocked`` and
``nms_sequential`` (they pick what :func:`nms_fixed` picks), the truncated
top-k eval path of ``postprocess_from_raws`` (``eval_grid_nms=False``, or
eval without NMS) and ``approx_max_k`` at recall 0.99
(``eval_approx_topk``); the last two raise.  ``approx_max_k`` at recall
1.0 is an exact top-k, so it is :func:`_top_k` here.

Ties: the JAX code ranks with ``jax.lax.top_k``, which puts equal scores in
index order.  ``torch.topk`` promises no order among ties, so every ranking
here is a stable descending sort, which does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import boxes as B
from yolo_v3_tpu_torch.ops.decode import xy_offset
from yolo_v3_tpu_torch.utils.profiling import span

# Larger than any supported input dimension (608) so class-offset boxes of
# distinct classes can never intersect.
_CLASS_OFFSET = 8192.0

# Below this many (box, class) score lanes the eval pair selection ranks
# the flat grid in one pass (the JAX cutoff, kept so that both rank ties
# alike).
_FLAT_TOPK_MAX = 16384

_DO_NOT_PORT = "on ROADMAP's do-not-port list"


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim, equal values in index order (the
    ``jax.lax.top_k`` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...], idx [B, M] -> [B, M, ...]."""
    ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, ix)


# ---------------------------------------------------------------------------
# Candidate selection
# ---------------------------------------------------------------------------

def _candidates_display(probs: torch.Tensor, conf_thr: float):
    """One candidate per box: its argmax class, 0 below ``conf_thr``."""
    score = probs.amax(dim=-1)
    score = torch.where(score > conf_thr, score, torch.zeros_like(score))
    return score, probs.argmax(dim=-1)


def _topk_pairs_eval(probs: torch.Tensor, k: int):
    """Top-k over the [..., N, C] (box, class) score grid, the eval-mode
    candidate selection.  Above :data:`_FLAT_TOPK_MAX` lanes (and k <= N) in
    two stages: the k boxes with the highest per-box max, then their k*C
    pairs; exact as a set (were a top-k pair's box dropped by stage 1, k
    boxes would each hold a better pair).  Returns (score [..., k], box
    [..., k], cls [..., k])."""
    n, c = probs.shape[-2], probs.shape[-1]
    if n * c <= _FLAT_TOPK_MAX or k > n:
        score, pair = _top_k(probs.reshape(probs.shape[:-2] + (n * c,)), k)
        return score, pair // c, pair % c
    _, bi = _top_k(probs.amax(dim=-1), k)
    sub = torch.gather(probs, -2, bi[..., None].expand(bi.shape + (c,)))
    score, pi = _top_k(sub.reshape(sub.shape[:-2] + (k * c,)), k)
    return score, torch.gather(bi, -1, pi // c), pi % c


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _fixpoint(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy NMS as the fixpoint of ``keep[i] = valid[i] and no kept j with
    overlap[j, i]``, iterated from all-kept (at most K rounds).  Each round
    ends in a host sync (``torch.equal``) and is a ``yolo.nms.round`` span."""
    keep = valid
    for _ in range(valid.shape[-1]):
        with span("nms.round"):
            suppressed = (overlap & keep[..., :, None]).any(dim=-2)
            new_keep = valid & ~suppressed
            done = torch.equal(new_keep, keep)
        keep = new_keep
        if done:
            break
    return keep


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
    of index order.  Returns (indices [..., M] int64, valid [..., M] bool) in
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
    keep = _fixpoint(upper & (iou > nms_thr), valid)   # j suppresses i

    masked = torch.where(keep, scores, torch.zeros_like(scores))
    m_eff = min(max_detections, k)
    top_scores, out_idx = _top_k(masked, m_eff)
    if m_eff < max_detections:
        pad = list(scores.shape[:-1]) + [max_detections - m_eff]
        top_scores = torch.cat([top_scores, top_scores.new_zeros(pad)], dim=-1)
        out_idx = torch.cat([out_idx, out_idx.new_zeros(pad)], dim=-1)
    return out_idx, top_scores > 0.0


def nms_pairs_grid(
    live: torch.Tensor,
    boxes: torch.Tensor,
    nms_thr: float,
    max_detections: int,
    block: int = 128,
):
    """Exact greedy class-wise NMS over the [B, K, C] pair-score grid, with
    candidate selection done in the NMS rounds (no sort of the K*C lanes).

    Per round, for every image: (1) the top ``block`` live pairs, exactly,
    through the two-stage argument of :func:`_topk_pairs_eval`; (2) greedy
    NMS of that set by the [T, T] class-offset IoU fixpoint (every member is
    picked or suppressed by a pick, and every pick is a global pick); (3)
    every grid pair of a pick's class that overlaps it dies, then the round's
    set itself.  Equal to greedy NMS over every pair above threshold.

    ``live`` [B, K, C] pair scores, 0 = dead; ``boxes`` [B, K, 4] xyxy,
    shared by the classes.  Returns (sel_box [B, M] into K, sel_cls [B, M],
    sel_score [B, M], valid [B, M]), picks in descending score order.
    """
    bsz, k, c = live.shape
    t = min(block, k * c)
    t_box = min(t, k)
    m = max_detections
    dev = live.device
    live = live.float().clone()
    # one slot past the M outputs takes the writes to drop
    sel_box = torch.zeros((bsz, m + 1), dtype=torch.int64, device=dev)
    sel_cls = torch.zeros((bsz, m + 1), dtype=torch.int64, device=dev)
    sel_score = torch.zeros((bsz, m + 1), dtype=torch.float32, device=dev)
    valid = torch.zeros((bsz, m + 1), dtype=torch.bool, device=dev)
    count = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    idx = torch.arange(t, device=dev)
    upper = idx[:, None] < idx[None, :]
    rows = torch.arange(bsz, device=dev)[:, None]

    while bool((live > 0.0).any()):
        _, bi = _top_k(live.amax(dim=-1), t_box)                     # [B, Tb]
        sub = _gather_rows(live, bi)                                 # [B, Tb, C]
        ts, pi = _top_k(sub.reshape(bsz, t_box * c), t)
        p_cls = pi % c                                               # [B, T]
        p_box = torch.gather(bi, 1, pi // c)                         # into K
        tb = _gather_rows(boxes, p_box)                              # [B, T, 4]
        shifted = tb + (p_cls.float() * _CLASS_OFFSET)[..., None]
        keep = _fixpoint(upper & (B.iou_matrix(shifted, shifted) > nms_thr), ts > 0.0)

        # picks go to their global places: scores fall from round to round
        pos = count[:, None] + torch.cumsum(keep.long(), dim=1) - 1
        wpos = torch.where(keep & (pos < m), pos, torch.full_like(pos, m))
        sel_box.scatter_(1, wpos, p_box)
        sel_cls.scatter_(1, wpos, p_cls)
        sel_score.scatter_(1, wpos, ts)
        valid.scatter_(1, wpos, keep)
        count = count + keep.sum(dim=1)

        # kill: the picks' overlaps ([B, T, K]) times their class one-hots
        m1 = (keep[..., :, None] & (B.iou_matrix(tb, boxes) > nms_thr)).float()
        m2 = F.one_hot(p_cls, c).float() * keep[..., None].float()
        kill = torch.bmm(m1.transpose(1, 2), m2)                     # [B, K, C]
        live = torch.where(kill > 0.0, torch.zeros_like(live), live)
        # retire the round's set as well (a degenerate pick, whose IoU is
        # NaN, kills nothing, itself included)
        live[rows, p_box, p_cls] = 0.0
        # an image with M picks is done
        live = torch.where((count >= m)[:, None, None], torch.zeros_like(live), live)
    return sel_box[:, :m], sel_cls[:, :m], sel_score[:, :m], valid[:, :m]


# ---------------------------------------------------------------------------
# Output rows
# ---------------------------------------------------------------------------

def _rows(boxes, obj, score, cls, valid) -> torch.Tensor:
    """[B, M, 8] rows of selected candidates (boxes [B, M, 4], the rest
    [B, M]; ``cls`` float), invalid rows zeroed."""
    out = torch.cat([boxes, obj[..., None], score[..., None], cls[..., None],
                     valid.float()[..., None]], dim=-1)
    return out * valid.float()[..., None]


def _select(boxes, score, cls, obj, nms_thr: float, m: int, use_nms: bool,
            presorted: bool) -> torch.Tensor:
    """Class-wise NMS over K candidates [B, K] (``cls`` float), or without
    NMS the first M, which the caller has sorted by score."""
    if use_nms:
        shifted = boxes + (cls * _CLASS_OFFSET)[..., None]
        sel, valid = nms_fixed(shifted, score, nms_thr, m, presorted=presorted)
    else:
        bsz, k = score.shape
        m_eff = min(m, k)
        sel = torch.arange(m_eff, device=score.device).expand(bsz, m_eff)
        valid = score[:, :m_eff] > 0.0
        if m_eff < m:
            sel = torch.cat([sel, sel.new_zeros((bsz, m - m_eff))], dim=1)
            valid = torch.cat([valid, valid.new_zeros((bsz, m - m_eff))], dim=1)
    return _rows(_gather_rows(boxes, sel), torch.gather(obj, 1, sel),
                 torch.gather(score, 1, sel), torch.gather(cls, 1, sel), valid)


# ---------------------------------------------------------------------------
# The decoded-rows path
# ---------------------------------------------------------------------------

def _postprocess_batch(det, num_classes, conf_thr, nms_thr, is_eval, use_nms,
                       pre_nms_topk, max_detections) -> torch.Tensor:
    """[B, N, 5+C] decoded rows -> [B, M, 8] (the JAX ``_postprocess_single``
    on every image): the top ``pre_nms_topk`` candidates, then NMS."""
    det = det.float()
    xyxy = B.cxcywh_to_x1y1x2y2(det[..., :4])
    obj = det[..., 4]
    probs = det[..., 5:5 + num_classes] * obj[..., None]
    if is_eval:
        masked = torch.where(probs > conf_thr, probs, torch.zeros_like(probs))
        k = min(pre_nms_topk, masked.shape[-2] * masked.shape[-1])
        score, box, cls = _topk_pairs_eval(masked, k)
    else:
        score_all, cls_all = _candidates_display(probs, conf_thr)
        k = min(pre_nms_topk, score_all.shape[-1])
        score, box = _top_k(score_all, k)
        cls = torch.gather(cls_all, 1, box)
    return _select(_gather_rows(xyxy, box), score, cls.float(), torch.gather(obj, 1, box),
                   nms_thr, max_detections, use_nms, presorted=True)


def postprocess(
    detections: torch.Tensor,
    num_classes: int,
    conf_thr: float = 0.5,
    nms_thr: float = 0.4,
    is_eval: bool = False,
    use_nms: bool = True,
    pre_nms_topk: int = 512,
    max_detections: int = 128,
    grid_nms: bool = False,
) -> torch.Tensor:
    """[B, N, 5+C] decoded detections -> [B, M, 8] rows (x1, y1, x2, y2,
    obj, prob, cls, valid).

    ``grid_nms=True`` (eval with NMS) runs :func:`nms_pairs_grid` over the
    whole [B, N, C] pair grid, with no ``pre_nms_topk`` truncation.
    """
    if is_eval and use_nms and grid_nms:
        det = detections.float()
        xyxy = B.cxcywh_to_x1y1x2y2(det[..., :4])
        obj = det[..., 4]
        probs = det[..., 5:5 + num_classes] * obj[..., None]
        live = torch.where(probs > conf_thr, probs, torch.zeros_like(probs))
        sel_box, sel_cls, sel_score, valid = nms_pairs_grid(live, xyxy, nms_thr,
                                                            max_detections)
        return _rows(_gather_rows(xyxy, sel_box), torch.gather(obj, 1, sel_box), sel_score,
                     sel_cls.float(), valid)
    return _postprocess_batch(detections, num_classes, conf_thr, nms_thr, is_eval,
                              use_nms, pre_nms_topk, max_detections)


# ---------------------------------------------------------------------------
# Decode constants of flattened candidates
# ---------------------------------------------------------------------------

def _scale_constants(shapes, anchor_masks, anchors, img_dim, device=None, scale_x_y=None):
    """Per-candidate decode constants over all scales: (cx, cy, anchor w,
    anchor h, stride), and each candidate's ``scale_x_y`` where the heads
    have one, each [N_total] float32, rows in ``decode_all``'s order
    (scales in order, then (h, w, a))."""
    cxs, cys, aws, ahs, strides, sxys = [], [], [], [], [], []
    for i_s, ((h, w), mask) in enumerate(zip(shapes, anchor_masks)):
        a = len(mask)
        cxs.append(np.tile(np.arange(w, dtype=np.float32)[None, :, None], (h, 1, a)).ravel())
        cys.append(np.tile(np.arange(h, dtype=np.float32)[:, None, None], (1, w, a)).ravel())
        for out, j in ((aws, 0), (ahs, 1)):
            anchor = np.asarray([anchors[i][j] for i in mask], np.float32)
            out.append(np.tile(anchor[None, None, :], (h, w, 1)).ravel())
        strides.append(np.full(h * w * a, img_dim / h, np.float32))
        if scale_x_y is not None:
            sxys.append(np.full(h * w * a, scale_x_y[i_s], np.float32))
    consts = []
    for v in (cxs, cys, aws, ahs, strides) + ((sxys,) if scale_x_y is not None else ()):
        host = np.concatenate(v)
        with span("h2d"):
            consts.append(torch.from_numpy(host).to(device))
    return tuple(consts)


def _constants_from_index(gi, shapes, anchor_masks, anchors, img_dim, n_a, scale_x_y=None):
    """The decode constants of :func:`_scale_constants` for flattened
    candidate indices ``gi``, computed from the index (no table gather)."""
    zeros = torch.zeros(gi.shape, dtype=torch.float32, device=gi.device)
    cx, cy, aw, ah, st, sxy = (zeros.clone() for _ in range(6))
    base = 0
    for j_s, ((h, w), mask) in enumerate(zip(shapes, anchor_masks)):
        n_s = h * w * n_a
        in_s = (gi >= base) & (gi < base + n_s)
        local = gi - base
        a_i = local % n_a
        cell = local // n_a
        aw_s = torch.full(gi.shape, float(anchors[mask[0]][0]), device=gi.device)
        ah_s = torch.full(gi.shape, float(anchors[mask[0]][1]), device=gi.device)
        for j in range(1, len(mask)):
            aw_s = torch.where(a_i == j, float(anchors[mask[j]][0]), aw_s)
            ah_s = torch.where(a_i == j, float(anchors[mask[j]][1]), ah_s)
        cx = torch.where(in_s, (cell % w).float(), cx)
        cy = torch.where(in_s, (cell // w).float(), cy)
        aw = torch.where(in_s, aw_s, aw)
        ah = torch.where(in_s, ah_s, ah)
        st = torch.where(in_s, img_dim / h, st)
        if scale_x_y is not None:
            sxy = torch.where(in_s, float(scale_x_y[j_s]), sxy)
        base += n_s
    return (cx, cy, aw, ah, st) + ((sxy,) if scale_x_y is not None else ())


def _decode_boxes(rows, cx, cy, aw, ah, st, sxy=None) -> torch.Tensor:
    """Corner boxes of gathered raw rows [..., >= 4] with their constants
    (``sxy``: each row's ``scale_x_y``, or None)."""
    r = rows[..., :4].float()
    bx = (xy_offset(r[..., 0], sxy) + cx) * st
    by = (xy_offset(r[..., 1], sxy) + cy) * st
    bw = torch.exp(r[..., 2]) * aw
    bh = torch.exp(r[..., 3]) * ah
    return torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], dim=-1)


# ---------------------------------------------------------------------------
# The fused path
# ---------------------------------------------------------------------------

def _postprocess_fast_display(raws, config, img_dim, conf_thr, nms_thr,
                              use_nms: bool, per_scale_k: int,
                              scale_x_y=None) -> torch.Tensor:
    """Display-mode postprocess with per-scale candidate selection: each
    scale's top ``per_scale_k`` rows by score (argmax class prob x obj, 0
    below ``conf_thr``), decoded, then class-wise greedy NMS over their union.
    ``raws`` are NHWC raw heads, coarse first."""
    C = config.num_classes
    attrib = 5 + C
    A = config.anchors_per_scale

    boxes_l, score_l, cls_l, obj_l = [], [], [], []
    for j_s, (raw, mask) in enumerate(zip(raws, config.anchor_masks)):
        b, h, w, _ = raw.shape
        stride = img_dim / h
        sxy = None if scale_x_y is None else scale_x_y[j_s]
        dev = raw.device
        with span("h2d"):
            aw_c = torch.tensor([config.anchors[i][0] for i in mask],
                                dtype=torch.float32, device=dev)
        with span("h2d"):
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
        bx = (xy_offset(row[..., 0], sxy) + gx) * stride
        by = (xy_offset(row[..., 1], sxy) + gy) * stride
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
    if not use_nms:
        # the first M rows must be the best M: sort the (small) merged set
        score, perm = _top_k(score, score.shape[1])
        boxes, cls, obj = (_gather_rows(t, perm) for t in (boxes, cls, obj))
    # order-free NMS: the priority mask replaces the global sort
    return _select(boxes, score, cls, obj, nms_thr, config.max_detections, use_nms,
                   presorted=False)


def _postprocess_eval_grid(flat, obj, cls_l, shapes, config, img_dim, conf_thr,
                           nms_thr, k, scale_x_y=None) -> torch.Tensor:
    """Eval mode: the top ``k`` boxes by their best pair score (every box when
    there are fewer), decoded, then :func:`nms_pairs_grid` over their pair
    grid."""
    n_total = flat.shape[1]
    n_box = min(k, n_total)
    box_key = torch.sigmoid(cls_l.amax(dim=-1)) * obj                    # [B, N]
    box_key = torch.where(box_key > conf_thr, box_key, torch.zeros_like(box_key))
    if n_box < n_total:
        _, bi = _top_k(box_key, n_box)
        rows = _gather_rows(flat, bi)
    else:
        bi = torch.arange(n_total, device=flat.device).expand(flat.shape[0], n_total)
        rows = flat
    sub_obj_l = rows[..., 4].float()
    sub_probs = torch.sigmoid(rows[..., 5:].float()) * torch.sigmoid(sub_obj_l)[..., None]
    sub_masked = torch.where(sub_probs > conf_thr, sub_probs, torch.zeros_like(sub_probs))
    consts = _constants_from_index(bi, shapes, config.anchor_masks, config.anchors,
                                   img_dim, config.anchors_per_scale, scale_x_y)
    boxes_all = _decode_boxes(rows, *consts)                           # [B, n_box, 4]
    sel_box, sel_cls, sel_score, valid = nms_pairs_grid(sub_masked, boxes_all, nms_thr,
                                                        config.max_detections)
    return _rows(_gather_rows(boxes_all, sel_box),
                 torch.gather(torch.sigmoid(sub_obj_l), 1, sel_box), sel_score,
                 sel_cls.float(), valid)


def postprocess_from_raws(raws, config, img_dim: int, conf_thr: float,
                          nms_thr: float, is_eval: bool = False,
                          use_nms: bool = True, scale_x_y=None) -> torch.Tensor:
    """Raw NHWC heads (coarse first) -> [B, M, 8] detection rows in
    input-image pixels, without materializing the decoded [B, N, 5+C] rows:
    scores come from the logits, and only the selected rows are decoded.
    Equal to :func:`~yolo_v3_tpu_torch.ops.decode.decode_all` +
    :func:`postprocess` up to float rounding.  ``scale_x_y``: one per head,
    or None."""
    if is_eval:
        if config.eval_approx_topk:
            raise NotImplementedError(
                f"eval_approx_topk (approx_max_k at recall 0.99) is {_DO_NOT_PORT}")
        if not (use_nms and config.eval_grid_nms):
            raise NotImplementedError(
                f"the truncated top-k eval path (eval_grid_nms=False, or eval without "
                f"NMS) is {_DO_NOT_PORT}; eval mode runs nms_pairs_grid")
    elif config.display_per_scale_topk > 0:
        return _postprocess_fast_display(
            raws, config, img_dim, conf_thr, nms_thr, use_nms,
            config.display_per_scale_topk, scale_x_y)

    C = config.num_classes
    n_a = config.anchors_per_scale
    # [B, N, 5+C]: channels (a, attrib), rows (h, w, a), as decode_all
    flat = torch.cat([r.reshape(r.shape[0], r.shape[1] * r.shape[2] * n_a, 5 + C)
                      for r in raws], dim=1)
    shapes = tuple((r.shape[1], r.shape[2]) for r in raws)
    n_total = flat.shape[1]
    obj = torch.sigmoid(flat[..., 4].float())
    cls_l = flat[..., 5:].float()
    if is_eval:
        k = min(config.eval_pre_nms_topk, n_total * C)
        return _postprocess_eval_grid(flat, obj, cls_l, shapes, config, img_dim,
                                      conf_thr, nms_thr, k, scale_x_y)

    # global top-k display: the best pre_nms_topk boxes by their argmax class
    k = min(config.pre_nms_topk, n_total)
    score = obj * torch.sigmoid(cls_l.amax(dim=-1))
    score = torch.where(score > conf_thr, score, torch.zeros_like(score))
    top_score, top_i = _top_k(score, k)
    top_cls = torch.gather(cls_l.argmax(dim=-1), 1, top_i).float()
    consts = _scale_constants(shapes, config.anchor_masks, config.anchors, img_dim,
                              flat.device, scale_x_y)
    boxes = _decode_boxes(_gather_rows(flat, top_i), *(c[top_i] for c in consts))
    return _select(boxes, top_score, top_cls, torch.gather(obj, 1, top_i), nms_thr,
                   config.max_detections, use_nms, presorted=True)


def detections_to_lists(results) -> List[np.ndarray]:
    """[B, M, 8] -> per-image [n_i, 7] numpy arrays
    (x1, y1, x2, y2, obj, prob, cls)."""
    results = results.detach().cpu().numpy() if torch.is_tensor(results) \
        else np.asarray(results)
    return [row[row[:, 7] > 0.5, :7] for row in results]
