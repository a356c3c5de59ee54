"""Closed-loop serving: one client calls ``Detector.detect`` on batches of
scenes, the next call as soon as the last one's rows are on the host.

Mix parameters (``traffic/<mix>.json``): ``batch`` images a call, drawn in
order from a ``pool`` of seeded scenes made before the window (sizes
``sizes_wh`` in turn), the postprocess's ``conf_thr``, ``nms_thr``,
``per_scale_topk`` and ``max_detections``, ``calib_images`` (the int8
configuration calibrates on the pool's first ones), ``warmup_calls``,
``sample_calls`` (calls kept for the output checks, a uniform sample of the
window drawn from the seed) and, for the traced run, ``trace_skip`` and
``trace_calls`` (the slice of the window that is profiled).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, scenes, trace, weights

SCENE_STREAM = 1 << 40        # the scenes' generator seed is the run's seed + this


class Probe:
    """Spans around the detector's preprocess, forward, postprocess and the
    rows' readback to the host, set from outside the program, and the
    outputs of the call being kept."""

    def __init__(self, det, detector_module, traced: bool):
        self.det, self.mod, self.traced = det, detector_module, traced
        self.keep = None
        self._pre, self._fwd = det.preprocess, det.model.forward
        self._post = detector_module.postprocess_from_raws
        self._readback = detector_module.detections_to_lists

        def pre(images, dim=None):
            with trace.span("preprocess", traced):
                out = self._pre(images, dim)
            if self.keep is not None:
                self.keep["x"] = out[0]
            return out

        def fwd(*a, **k):
            with trace.span("forward", traced):
                out = self._fwd(*a, **k)
            if self.keep is not None:
                self.keep["heads"] = out
            return out

        def post(*a, **k):
            with trace.span("postprocess", traced):
                return self._post(*a, **k)

        def readback(*a, **k):
            with trace.span("readback", traced):
                return self._readback(*a, **k)

        det.preprocess, det.model.forward = pre, fwd
        detector_module.postprocess_from_raws = post
        detector_module.detections_to_lists = readback

    def close(self):
        del self.det.preprocess
        del self.det.model.forward
        self.mod.postprocess_from_raws = self._post
        self.mod.detections_to_lists = self._readback


def well_formed(rows, images, num_classes: int) -> bool:
    if len(rows) != len(images):
        return False
    for r, im in zip(rows, images):
        if r.ndim != 2 or r.shape[1] != 7 or not np.isfinite(r).all():
            return False
        h, w = im.shape[:2]
        if not (np.all((r[:, 0] >= 0) & (r[:, 0] < num_classes) & (r[:, 0] == np.round(r[:, 0])))
                and np.all(r[:, 1:3] >= -1e-3) and np.all(r[:, 3:5] >= 0)
                and np.all(r[:, 1] + r[:, 3] <= w + 1e-2)
                and np.all(r[:, 2] + r[:, 4] <= h + 1e-2)
                and np.all((r[:, 5:] > 0) & (r[:, 5:] <= 1))):
            return False
    return True


def yolo_config(cfg: Dict, mix: Dict):
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    return YoloConfig(num_classes=cfg["classes"], img_dim=cfg["input_size"],
                      anchors=tuple(tuple(a) for a in cfg["anchors"]),
                      anchor_masks=tuple(tuple(m) for m in cfg["masks"]),
                      conf_thr=mix["conf_thr"], nms_thr=mix["nms_thr"],
                      display_per_scale_topk=mix["per_scale_topk"],
                      max_detections=mix["max_detections"])


def make_inputs(cfg: Dict, mix: Dict, seed: int, device):
    """(params, state, scene pool, calibration images) of a seed; the BN
    statistics are measured on the pool's first ``calib_images`` scenes, which
    the int8 configuration also calibrates on."""
    pool = scenes.make_pool(mix["pool"], mix["sizes_wh"], seed + SCENE_STREAM, device)
    params, state = weights.make(cfg, seed, device, pool[:mix["calib_images"]])
    calib = pool[:mix["calib_images"]] if cfg["precision"] == "int8" else None
    return params, state, pool, calib


def make_detector(cfg: Dict, mix: Dict, params, state, calib, device, precision=None):
    from yolo_v3_tpu_torch.detector import Detector

    return Detector(params, state, yolo_config(cfg, mix), precision=precision or cfg["precision"],
                    device=device, calib_images=calib)


def run(ctx) -> Dict:
    from yolo_v3_tpu_torch import detector as detector_module

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    bsz = mix["batch"]
    params, state, pool, calib = make_inputs(cfg, mix, ctx.seed, dev)
    n_batches = len(pool) // bsz

    def batch(j):
        return pool[j * bsz:(j + 1) * bsz]

    det = make_detector(cfg, mix, params, state, calib, dev)
    probe = Probe(det, detector_module, ctx.trace)
    for i in range(mix["warmup_calls"]):
        det.detect(batch(i % n_batches))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.setup_done()

    pick = np.random.default_rng([ctx.seed, 7])
    k = mix["sample_calls"]
    samples: List = [None] * k
    lat: List[float] = []
    attempted = failed = done = 0
    slice_lo, slice_hi = mix["trace_skip"], mix["trace_skip"] + mix["trace_calls"]
    prof = slice_span = None
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    i = 0
    while time.perf_counter() < deadline or (ctx.trace and i < slice_hi):
        if ctx.trace and i == slice_lo:
            prof = trace.profiler()
            prof.__enter__()
            slice_span = trace.span("slice", True)
            slice_span.__enter__()
        slot = i if i < k else int(pick.integers(0, i + 1))
        probe.keep = {} if slot < k else None
        j = i % n_batches
        images = batch(j)
        t0 = time.perf_counter()
        try:
            with trace.span("call", ctx.trace and slice_lo <= i < slice_hi):
                rows = det.detect(images)
            ok = well_formed(rows, images, cfg["classes"])
        except Exception as e:  # a failed call is counted and reported, not fatal
            ctx.log(f"call {i} raised {type(e).__name__}: {e}")
            ok = False
        t1 = time.perf_counter()
        attempted += 1
        lat.append(t1 - t0)
        if ok:
            done += len(images)
            if slot < k:
                samples[slot] = {"call": i, "batch": j, "rows": rows, **probe.keep}
        else:
            failed += 1
        probe.keep = None
        i += 1
        if ctx.trace and i == slice_hi:
            slice_span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        if failed >= 10:
            break
    t_end = time.perf_counter()
    if prof is not None and i < slice_hi:       # the window ended inside the slice
        slice_span.__exit__(None, None, None)
        prof.__exit__(None, None, None)

    out: Dict = {"attempted": attempted, "failed": failed,
                 "e2e": {"detect_imgs_per_s": done / (t_end - t_start),
                         "detect_p95_ms": float(np.percentile(lat, 95)) * 1e3}}
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if ctx.trace and prof is not None and i >= slice_hi:
        out["trace"] = {"trace": trace.Trace.from_profile(prof), "calls": mix["trace_calls"],
                        "images": mix["trace_calls"] * bsz}
    ctx.log(f"window: {attempted} calls, {failed} failed, {t_end - t_start:.3f} s")

    probe.close()
    del det, probe
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = [s for s in samples if s is not None]
    heads_fn = compare.reference_heads(cfg, params, state, calib, dev)
    out["checks"] = compare.judge(kept, batch, cfg, mix, heads_fn, dev)
    out["checked_calls"] = [s["call"] for s in kept]
    return out
