"""The comparisons that decide a serving run's ``correct``.

A sampled call's letterboxed batch, three raw heads and rows are held
against the plain references (``reference/``), recomputed from the same
scenes and seeded weights:

* ``letterbox_max_abs``: the largest |program - reference| of the
  letterboxed batch (values in [0, 1]);
* ``heads_rel_rms``: ||program head - reference head|| / ||reference
  head|| over every sampled call, for each of the three heads apart, the
  largest of the three (the coarse 13 x 13 head has a twentieth of the
  cells of the fine one, so a sum over all three would hide its faults);
* ``heads_centered_rms``: the same with each side's mean over the call's
  images taken out first: it judges the part of the heads that depends on
  the scene, which a batch mixed up, left out or served stale moves by about
  its own size;
* ``rows_unmatched_share``: the rows, the program's and the reference's,
  left without a partner (same class, box within 0.01 px, prob and obj
  within 1e-4), over all rows of both; the reference postprocesses the
  program's own heads, so this judges the postprocess alone.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from portbench.reference import letterbox as RL
from portbench.reference import postprocess as RP
from portbench.reference import yolov3 as RY

BOX_TOL = 1e-2
PROB_TOL = 1e-4


HEADS = 3


class Readings:
    def __init__(self):
        self.lb = 0.0
        self.sq = [{"diff": 0.0, "ref": 0.0, "cdiff": 0.0, "cref": 0.0} for _ in range(HEADS)]
        self.unmatched = self.rows = 0

    def add_heads(self, prog, ref):
        """One call's heads, program's and reference's."""
        if len(prog) != HEADS or len(ref) != HEADS:
            raise ValueError(f"expected {HEADS} heads, got {len(prog)} and {len(ref)}")
        for sq, p, r in zip(self.sq, prog, ref):
            p, r = p.double(), r.double().to(p.device)
            pc, rc = p - p.mean(0, keepdim=True), r - r.mean(0, keepdim=True)
            for k, v in (("diff", p - r), ("ref", r), ("cdiff", pc - rc), ("cref", rc)):
                sq[k] += float((v ** 2).sum())

    def add_rows(self, prog_rows, ref_rows):
        for a, b in zip(prog_rows, ref_rows):
            self.unmatched += (RP.unmatched(a, b, BOX_TOL, PROB_TOL)
                               + RP.unmatched(b, a, BOX_TOL, PROB_TOL))
            self.rows += len(a) + len(b)

    def numbers(self) -> Dict[str, float]:
        """The compared numbers, and each head's own (``.h0`` the coarse
        head), which are read but not compared."""
        out = {"letterbox_max_abs": self.lb}
        for name, num, den in (("heads_rel_rms", "diff", "ref"),
                               ("heads_centered_rms", "cdiff", "cref")):
            per = [math.sqrt(sq[num] / max(sq[den], 1e-30)) for sq in self.sq]
            out[name] = max(per)
            out.update({f"{name}.h{i}": v for i, v in enumerate(per)})
        out["rows_unmatched_share"] = self.unmatched / max(self.rows, 1)
        out["rows_compared"] = self.rows
        return out


def reference_heads(cfg: Dict, params, state, calib_images, device) -> Callable:
    """The configuration's reference forward: [B, S, S, 3] -> heads."""
    blocks = cfg["blocks"]
    if cfg["precision"] == "int8":
        net = int8_reference(cfg, params, state, calib_images, device, qmax=127)
        return net.heads
    return lambda x: RY.heads_float(params, state, x, blocks)


def int8_reference(cfg: Dict, params, state, calib_images, device, qmax: int):
    folded = RY.fold(params, state)
    x = RL.letterbox_batch(calib_images, cfg["input_size"], device).float()
    stats = RY.calibrate(folded, x, cfg["blocks"])
    return RY.Int8Net(folded, stats, cfg["blocks"], qmax=qmax)


def postprocess_rows(heads, images, cfg: Dict, mix: Dict, dtype=torch.float64):
    return RP.rows(heads, [(im.shape[1], im.shape[0]) for im in images], cfg["anchors"],
                   cfg["masks"], cfg["input_size"], mix["conf_thr"], mix["nms_thr"],
                   mix["per_scale_topk"], mix["max_detections"], dtype)


def judge(samples: List[Dict], batch_images: Callable, cfg: Dict, mix: Dict,
          heads_fn: Callable, device, block: int = 8,
          lb_precision: str = "fp64", post_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Readings over sampled calls.  Each sample holds ``batch`` (its index
    into the pool's batches), ``x`` (the letterboxed batch), ``heads`` and
    ``rows``.  ``lb_precision`` and ``post_dtype`` put a control in the
    program's place: the reference letterbox and postprocess in a lower
    precision stand for the program's, judged against the float64 ones."""
    r = Readings()
    size = cfg["input_size"]
    for s in samples:
        images = batch_images(s["batch"])
        ref_x = RL.letterbox_batch(images, size, device)
        x = s["x"] if lb_precision == "fp64" else RL.letterbox_batch(images, size, device,
                                                                       lb_precision)
        r.lb = max(r.lb, float((x.to(device).double() - ref_x).abs().max()))
        parts = [heads_fn(ref_x[i:i + block].float()) for i in range(0, len(images), block)]
        r.add_heads(s["heads"], [torch.cat(h) for h in zip(*parts)])
        ref_rows = postprocess_rows(s["heads"], images, cfg, mix)
        rows = (s["rows"] if post_dtype is None
                else postprocess_rows(s["heads"], images, cfg, mix, post_dtype))
        r.add_rows(rows, ref_rows)
    return r.numbers()
