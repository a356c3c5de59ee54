"""Closed-loop serving of YOLOv4: ``serve_closed.py``'s loop, ``Probe`` and
``well_formed``, run from a private instance of that module with the
YOLOv4 inputs, detector, reference and judge bound in (seeded weights
``weights_yolov4.py``, ``Detector(arch="yolov4")``, ``compare_yolov4.py``)
and a trace that keeps the program's ``yolo.*`` spans
(``trace_yolov4.py``).  The mix's parameters are ``serve_closed``'s.  A
program without YOLOv4 fails at once, before any weights are made.
"""

from __future__ import annotations

import types
from typing import Dict

from portbench import compare_yolov4, core, scenes, trace, trace_yolov4, weights_yolov4

_G = core.load_module(core.BENCH_DIR / "generators" / "serve_closed.py",
                      "portbench_generator_serve_closed_for_yolov4")
Probe, well_formed, yolo_config = _G.Probe, _G.well_formed, _G.yolo_config


def make_inputs(cfg: Dict, mix: Dict, seed: int, device):
    """(params, state, scene pool, None): the BN statistics measured on the
    pool's first ``calib_images`` scenes."""
    pool = scenes.make_pool(mix["pool"], mix["sizes_wh"], seed + _G.SCENE_STREAM, device)
    params, state = weights_yolov4.make(cfg, seed, device, pool[:mix["calib_images"]])
    return params, state, pool, None


def make_detector(cfg: Dict, mix: Dict, params, state, calib, device, precision=None):
    from yolo_v3_tpu_torch.detector import Detector

    return Detector(params, state, yolo_config(cfg, mix), precision=precision or cfg["precision"],
                    device=device, arch=cfg["arch"])


_G.make_inputs, _G.make_detector = make_inputs, make_detector
_G.compare = types.SimpleNamespace(reference_heads=compare_yolov4.reference_heads,
                                   judge=compare_yolov4.judge)
_G.trace = types.SimpleNamespace(span=trace.span, profiler=trace.profiler,
                                 Trace=trace_yolov4.Trace)


def run(ctx) -> Dict:
    import yolo_v3_tpu_torch.models.yolov4  # noqa: F401  (the program must have the model)

    return _G.run(ctx)
