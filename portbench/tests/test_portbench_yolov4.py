"""The YOLOv4 cell's own pieces on the CPU, at a toy size (``toy.py``: one
CSP block a stage, 4 classes, 64 x 64 input, batches of 2): the
generator, the traced slice's readers and the output checks end to end;
the counts against the figures of ``yolov4.cfg``; and a broken forward
judged not correct.  No number here is a device metric."""

import numpy as np
import pytest

from portbench import core, counts_yolov4, run
from portbench.tests.toy import context, toy_cell, toy_limits

CELL = "serve-yolov4-608-bf16-b32"
BLOCKS = (1, 2, 8, 8, 4)


def test_counts_match_the_published_config():
    layers = counts_yolov4.conv_layers(BLOCKS, 80, 608)
    assert len(layers) == 110
    assert sum(l["k"] ** 2 * l["cin"] * l["cout"] for l in layers) == 64296032
    assert counts_yolov4.forward_flops(BLOCKS, 80, 608) / 1e9 == pytest.approx(128.389, abs=1e-3)
    assert sum(l["act"] == "mish" for l in layers) == 72
    assert len(counts_yolov4._p2d_launches(layers)) == 51


def test_toy_run_and_readers():
    cell = toy_cell(CELL)
    gen = cell.generator()
    out = gen.run(context(cell, trace=1))
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert all(np.isfinite(out["checks"][k]) for k in cell.limits)
    correct, _ = core.verdict(out, toy_limits(cell, out))
    assert correct
    inputs = run.MetricInputs(cell, out["trace"])
    values = {m["name"]: core.read_metric(m["name"], inputs) for m in cell.per_layer()}
    # the program's spans are kept; the CPU has no device activity to put in them
    assert out["trace"]["trace"].program
    assert values["yolov4.backbone_device_ms"] is None
    assert values["csp_block_bf16_roofline"] is None
    assert values["yolov4_serve_mfu"] > 0


def test_toy_broken_forward_is_not_correct(monkeypatch):
    cell = toy_cell(CELL)
    sound = cell.generator().run(context(cell))
    gen = cell.generator()
    make = gen._G.make_detector

    def broken(*a, **k):
        det = make(*a, **k)
        fwd = det.model.forward
        det.model.forward = lambda *x, **kw: tuple(h * 1.3 for h in fwd(*x, **kw))
        return det

    monkeypatch.setattr(gen._G, "make_detector", broken)
    out = gen.run(context(cell))
    correct, _ = core.verdict(out, toy_limits(cell, sound))
    assert not correct
