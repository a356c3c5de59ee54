"""The serving path's spans (``utils/profiling.py::span``) in a
``torch.profiler`` trace: ``Detector.detect`` on the CPU, on a small net
(blocks (1, 1, 1, 1, 1), 2 classes, 64 px, conf 0.2 so that every image
has rows), read back from the exported Chrome trace as any trace reader
would; and the spans' absence, at the cost of one check, with no
profiler."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.utils import profiling
from yolo_v3_tpu_torch.utils.config import YoloConfig

CFG = YoloConfig(num_classes=2, img_dim=64, max_detections=16, conf_thr=0.2)
STAGES = ["yolo.preprocess", "yolo.forward", "yolo.postprocess", "yolo.readback"]
CALLS = 2


@pytest.fixture(scope="module")
def trees():
    return D.init_yolonet(torch.Generator().manual_seed(0), 2, blocks=(1, 1, 1, 1, 1))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((60, 80), (80, 60), (50, 70))]


_DETECTORS = {}


def _detector(trees, precision):
    if precision not in _DETECTORS:
        _DETECTORS[precision] = Detector(*trees, CFG, precision=precision, device="cpu")
    return _DETECTORS[precision]


def _spans(path):
    """The trace's ``yolo.*`` spans, in start order."""
    events = json.load(open(path))["traceEvents"]
    out = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda e: (e["ts"], -e["dur"]))


def _inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_detect_spans_in_a_chrome_trace(trees, images, precision, tmp_path):
    det = _detector(trees, precision)
    det.detect(images)          # the resize weights of these sizes are uploaded once
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            det.detect(images)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = _spans(tmp_path / "trace.json")
    calls = [s for s in spans if s["name"] == "yolo.detect"]
    assert len(calls) == CALLS
    for call in calls:
        inner = [s for s in spans if s is not call and _inside(s, call)]
        stages = [s for s in inner if s["name"] in STAGES]
        assert [s["name"] for s in stages] == STAGES
        for a, b in zip(stages, stages[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        h2d = [s for s in inner if s["name"] == "yolo.h2d"]
        rounds = [s for s in inner if s["name"] == "yolo.nms.round"]
        # the preprocess stages the batch with no blocking copy; the
        # postprocess: 6 anchor tensors and the net's input size (width, height)
        assert len(h2d) == 6 + 2
        assert sum(_inside(s, stages[0]) for s in h2d) == 0
        assert sum(_inside(s, stages[2]) for s in h2d) == 6 + 2
        assert rounds and all(_inside(s, stages[2]) for s in rounds)
        assert len(inner) == len(STAGES) + len(h2d) + len(rounds)
    assert all(any(_inside(s, c) for c in calls) for s in spans)


def test_trace_records_the_spans(trees, images, tmp_path):
    """``profiling.trace`` is one of the profilers that turn them on."""
    det = _detector(trees, "bf16")
    with profiling.trace(str(tmp_path)):
        det.detect(images)
    names = {s["name"] for s in _spans(tmp_path / "trace.json")}
    assert names == {"yolo.detect", "yolo.h2d", "yolo.nms.round", *STAGES}


def test_no_profiler_no_span(trees, images, monkeypatch):
    """Without a profiler ``span`` hands out one shared null context and
    never enters ``record_function``."""
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("detect")
    assert isinstance(off, contextlib.nullcontext) and profiling.span("h2d") is off

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rows = _detector(trees, "bf16").detect(images)
    assert len(rows) == len(images)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_rows_equal_with_and_without_the_profiler(trees, images, precision):
    det = _detector(trees, precision)
    plain = det.detect(images)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = det.detect(images)
    assert len(plain) == len(traced) and all(len(r) for r in plain)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
