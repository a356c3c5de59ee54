"""The comparisons that decide the YOLOv4 cell's ``correct``: the numbers
of ``compare.py`` (``compare.Readings``), with the plain YOLOv4 forward and
postprocess (``reference/yolov4.py``: every head's ``scale_x_y``) in the
references' place."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from portbench.compare import Readings
from portbench.reference import letterbox as RL
from portbench.reference import yolov4 as RY4


def reference_heads(cfg: Dict, params, state, calib_images, device,
                    operand_round=None) -> Callable:
    """The configuration's reference forward: [B, S, S, 3] -> heads
    (``operand_round``: a control's rounding of every conv's operands)."""
    return lambda x: RY4.heads_float(params, state, x, cfg["blocks"],
                                     operand_round=operand_round)


def postprocess_rows(heads, images, cfg: Dict, mix: Dict, dtype=torch.float64):
    return RY4.rows(heads, [(im.shape[1], im.shape[0]) for im in images], cfg["anchors"],
                    cfg["masks"], cfg["scale_x_y"], cfg["input_size"], mix["conf_thr"],
                    mix["nms_thr"], mix["per_scale_topk"], mix["max_detections"], dtype)


def judge(samples: List[Dict], batch_images: Callable, cfg: Dict, mix: Dict,
          heads_fn: Callable, device, block: int = 8,
          lb_precision: str = "fp64", post_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Readings over sampled calls, as ``compare.judge``: each sample holds
    ``batch``, ``x`` (the letterboxed batch), ``heads`` and ``rows``;
    ``lb_precision`` and ``post_dtype`` put a control's letterbox and
    postprocess in the program's place."""
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
