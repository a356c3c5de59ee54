"""Plain YOLOv4 (CSPDarknet53, SPP, PANet; arXiv:2004.10934, darknet's
``cfg/yolov4.cfg``) in float32, TF32 off, and its display-mode postprocess.

Every conv is SAME (pad k // 2), then BatchNorm with running statistics
(eps 1e-5) and its activation; the detection convs have a bias and no BN
or activation.  Mish is ``x * tanh(softplus(x))`` with darknet's softplus
threshold (``softplus(x) = x`` above 20).  Routes, in the cfg's layer
numbers:

* stem 0 (3x3, 32, Mish); five CSP stages, each: down (3x3/2), split0 (1x1;
  layers 2, 12, 25, 56, 87), route -2, split1 (1x1), n residual blocks
  (1x1, 3x3, shortcut -3 linear: ``t + mish(conv2(mish(conv1(t))))``),
  trans (1x1), route [trans, split0] (layers 9, 22, 53, 84, 103), fuse
  (1x1); all Mish.  Widths: down 64 / 128 / 256 / 512 / 1024; split 64 in
  stage 0 (block 64 -> 32 -> 64), half the down's width after (blocks with
  Cmid = C); n = 1, 2, 8, 8, 4.  Stages 2, 3, 4 end at layers 54, 85, 104;
* 105-107 (1x1 512, 3x3 1024, 1x1 512, leaky, as the whole neck), SPP:
  max-pools 5, 9, 13 at stride 1 (-inf padding), route [-1, -3, -5, -6] =
  [mp13, mp9, mp5, x] (113); 114-116 (1x1 512, 3x3 1024, 1x1 512: P5);
* 117 (1x1 256), upsample 2x nearest (118), route 85, 120 (1x1 256), route
  [120, 118] (121), 122-126 (five convs 256 / 512: P4); 127 (1x1 128),
  upsample (128), route 54, 130 (1x1 128), route [130, 128] (131), 132-136
  (five convs 128 / 256: P3);
* 137 (3x3 256), 138 (1x1 255, linear): the 76x76 head at 608 (mask 0, 1,
  2, scale_x_y 1.2); route 136, 141 (3x3/2 256), route [141, 126] (142),
  143-147 (five convs 256 / 512), 148 (3x3 512), 149 (det): 38x38 (mask 3,
  4, 5, scale_x_y 1.1); route 147, 152 (3x3/2 512), route [152, 116] (153),
  154-158 (five convs 512 / 1024), 159 (3x3 1024), 160 (det): 19x19 (mask
  6, 7, 8, scale_x_y 1.05).

Heads return coarse first.  Departures from the cfg: BN's eps is 1e-5 added
to the variance (the trees' convention; darknet adds 1e-6 to the standard
deviation); the trees are the benchmark's seeded ones, not
``yolov4.weights``.  The postprocess (:func:`rows`) decodes
``bx = (sigmoid(tx) * s - (s - 1) / 2 + cx) * stride`` (darknet's
``scale_x_y``), ``bw = exp(tw) * anchor``, and keeps the serving semantics
of ``reference/postprocess.py`` (one candidate a cell-anchor, its best class;
per-scale top-k; class-wise greedy NMS, ``yolov4.cfg``'s ``greedynms``; the
letterbox's geometry back to the image), whose helpers it uses.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import postprocess as RP
from portbench.reference import tf32

EPS = 1e-5
SLOPE = 0.1
SOFTPLUS_THRESHOLD = 20.0
BLOCKS = (1, 2, 8, 8, 4)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x, threshold=SOFTPLUS_THRESHOLD))


def _get(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def heads_float(params: Dict, state: Dict, x: torch.Tensor, blocks=BLOCKS,
                measure: bool = False,
                operand_round: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """[B, H, W, 3] float images -> the three raw heads, coarse first, NHWC
    float32.  ``measure`` normalizes with the batch's own mean and biased
    variance and writes them into ``state`` as its statistics (BN
    re-estimation).  ``operand_round`` rounds every conv's input and weight
    first (a control's lower precision)."""
    rnd = operand_round or (lambda t: t)

    def conv(path, y, stride=1):
        p = _get(params, path)
        w = rnd(p["w"].float().permute(3, 2, 0, 1))
        y = F.conv2d(rnd(y), w, None, stride, (w.shape[2] - 1) // 2)
        if "bn" not in p:
            return y + p["b"].float()[:, None, None]
        s = _get(state, path)
        if measure:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            s["var"], s["mean"] = var, mean
        else:
            mean, var = s["mean"].float(), s["var"].float()
        inv = p["bn"]["scale"].float() / torch.sqrt(var + EPS)
        return (y - mean[:, None, None]) * inv[:, None, None] + p["bn"]["bias"].float()[:, None, None]

    def cbm(path, y, stride=1):
        return mish(conv(path, y, stride))

    def cbl(path, y, stride=1):
        return F.leaky_relu(conv(path, y, stride), SLOPE)

    def five(pre, y):
        for j in range(5):
            y = cbl(f"{pre}/conv{j}", y)
        return y

    with tf32(False):
        y = cbm("backbone/stem", x.float().permute(0, 3, 1, 2))
        routes = []
        for i, n in enumerate(blocks):
            pre = f"backbone/stage{i}"
            y = cbm(f"{pre}/down", y, 2)
            a = cbm(f"{pre}/split0", y)
            t = cbm(f"{pre}/split1", y)
            for b in range(n):
                t = t + cbm(f"{pre}/res{b}/conv2", cbm(f"{pre}/res{b}/conv1", t))
            y = cbm(f"{pre}/fuse", torch.cat([cbm(f"{pre}/trans", t), a], 1))
            routes.append(y)
        s54, s85, s104 = routes[-3:]
        x = cbl("neck/spp_in/conv2", cbl("neck/spp_in/conv1", cbl("neck/spp_in/conv0", s104)))
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in (13, 9, 5)]
        y = torch.cat(pools + [x], 1)
        p5 = cbl("neck/spp_out/conv2", cbl("neck/spp_out/conv1", cbl("neck/spp_out/conv0", y)))
        p4 = five("neck/td0", torch.cat([cbl("neck/lat0", s85), _up2(cbl("neck/up0", p5))], 1))
        p3 = five("neck/td1", torch.cat([cbl("neck/lat1", s54), _up2(cbl("neck/up1", p4))], 1))
        d2 = conv("head2/det", cbl("head2/conv", p3))
        n4 = five("neck/bu0", torch.cat([cbl("neck/down0", p3, 2), p4], 1))
        d1 = conv("head1/det", cbl("head1/conv", n4))
        n5 = five("neck/bu1", torch.cat([cbl("neck/down1", n4, 2), p5], 1))
        d0 = conv("head0/det", cbl("head0/conv", n5))
    return tuple(d.permute(0, 2, 3, 1).contiguous() for d in (d0, d1, d2))


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through fp8 e4m3 as an fp8 GEMM takes an operand: scaled by its
    absmax onto e4m3's range (448), rounded to nearest, scaled back."""
    amax = t.abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (t * s).clamp(-448, 448).to(torch.float8_e4m3fn).float() / s


def rows(heads: Sequence[torch.Tensor], org_wh: Sequence[Sequence[int]], anchors, masks,
         scale_x_y: Sequence[float], img_dim: int, conf: float, nms: float, topk: int,
         max_det: int, dtype=torch.float64) -> List[np.ndarray]:
    """Display-mode rows [cls, x, y, w, h, prob, obj] of each image
    (``reference/postprocess.py::rows`` with each head's ``scale_x_y``)."""
    heads = [h.detach().to("cpu", dtype) for h in heads]
    out = []
    for b, (ow, oh) in enumerate(org_wh):
        boxes, score, cls, obj = [], [], [], []
        for raw, mask, sxy in zip(heads, masks, scale_x_y):
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
            off = (sxy - 1) / 2
            bx = (torch.sigmoid(sel[:, 0]) * sxy - off + (cell % gw).to(dtype)) * stride
            by = (torch.sigmoid(sel[:, 1]) * sxy - off + (cell // gw).to(dtype)) * stride
            bw = torch.exp(sel[:, 2]) * aw
            bh = torch.exp(sel[:, 3]) * ah
            boxes.append(torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], 1))
            score.append(s[order])
            cls.append(torch.argmax(sel[:, 5:], dim=1))
            obj.append(torch.sigmoid(sel[:, 4]))
        boxes, score, cls, obj = (torch.cat(t) for t in (boxes, score, cls, obj))
        keep = RP._greedy_nms(boxes, score, cls, nms)[:max_det]
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
