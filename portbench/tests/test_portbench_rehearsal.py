"""A toy-size rehearsal of every cell on the CPU: the generator, the traced
slice's readers and the output checks run end to end, and the timed path
broken underneath comes out not correct (see ``toy.py`` for the limits a
toy run is held to).  No number here is a device metric."""

import numpy as np
import pytest
import torch

from portbench import core, run
from portbench.tests.toy import cells, context, toy_cell, toy_limits

SERVE = cells("serve_closed")


def _run(cell, monkeypatch=None, fault=None, **kw):
    gen = cell.generator()
    if fault is not None:
        fault(gen, monkeypatch)
    return gen.run(context(cell, **kw))


@pytest.mark.parametrize("name", SERVE)
def test_toy_run(name):
    cell = toy_cell(name)
    out = _run(cell)
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert set(cell.limits) <= set(out["checks"])
    assert all(np.isfinite(out["checks"][k]) for k in cell.limits)
    correct, _ = core.verdict(out, toy_limits(cell, out))
    assert correct


@pytest.mark.parametrize("name", SERVE)
def test_toy_trace_readers(name):
    cell = toy_cell(name)
    out = _run(cell, trace=1)
    inputs = run.MetricInputs(cell, out["trace"])
    assert out["trace"]["trace"].window_s() > 0
    for m in cell.per_layer():
        core.read_metric(m["name"], inputs)
    # the CPU has no device activity: readers of device time find nothing
    assert core.read_metric(cell.per_layer()[0]["name"], inputs) is not None
    assert out["trace"]["trace"].busy_s() == 0


def _detector_fault(wrap):
    def fault(gen, monkeypatch):
        make = gen.make_detector

        def broken(*a, **k):
            det = make(*a, **k)
            wrap(det, monkeypatch)
            return det

        monkeypatch.setattr(gen, "make_detector", broken)
    return fault


@_detector_fault
def half_batch(det, monkeypatch):
    fwd = det.model.forward

    def half(x, *a, **k):
        heads = fwd(x[: len(x) // 2], *a, **k)
        return tuple(torch.cat([h, h]) for h in heads)

    monkeypatch.setattr(det.model, "forward", half)


@_detector_fault
def stale_heads(det, monkeypatch):
    fwd, first = det.model.forward, []

    def stale(x, *a, **k):
        if not first:
            first.append(fwd(x, *a, **k))
        return first[0]

    monkeypatch.setattr(det.model, "forward", stale)


@_detector_fault
def altered_answer(det, monkeypatch):
    detect = det.detect

    def altered(images, *a, **k):
        rows = detect(images, *a, **k)
        for r in rows:
            r[:, 5] = r[:, 5] * 0.99
        return rows

    monkeypatch.setattr(det, "detect", altered)


@_detector_fault
def coarse_head_zeroed(det, monkeypatch):
    fwd = det.model.forward

    def zeroed(x, *a, **k):
        heads = fwd(x, *a, **k)
        return (torch.zeros_like(heads[0]),) + tuple(heads[1:])

    monkeypatch.setattr(det.model, "forward", zeroed)


@_detector_fault
def coarse_head_mixed_up(det, monkeypatch):
    fwd = det.model.forward

    def mixed(x, *a, **k):
        heads = fwd(x, *a, **k)
        return (heads[0].roll(1, 0),) + tuple(heads[1:])

    monkeypatch.setattr(det.model, "forward", mixed)


@_detector_fault
def coarse_head_noisy(det, monkeypatch):
    """Noise of half the coarse head's own RMS on it alone: in a sum over
    the three heads it would read under the int8 cell's limit."""
    fwd, gen = det.model.forward, torch.Generator().manual_seed(0)

    def noisy(x, *a, **k):
        heads = fwd(x, *a, **k)
        h0 = heads[0].float()
        noise = torch.randn(h0.shape, generator=gen).to(h0.device)
        h0 = h0 + 0.5 * h0.pow(2).mean().sqrt() * noise
        return (h0.to(heads[0].dtype),) + tuple(heads[1:])

    monkeypatch.setattr(det.model, "forward", noisy)


FAULTS = {"half-batch": half_batch, "stale-heads": stale_heads,
          "altered-answer": altered_answer, "coarse-head-zeroed": coarse_head_zeroed,
          "coarse-head-mixed-up": coarse_head_mixed_up, "coarse-head-noisy": coarse_head_noisy}


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", list(FAULTS.values()), ids=list(FAULTS))
def test_toy_serving_faults_are_not_correct(name, fault, monkeypatch):
    cell = toy_cell(name)
    limits = toy_limits(cell, _run(cell))
    out = _run(cell, monkeypatch, fault)
    correct, checks = core.verdict(out, limits)
    assert not correct, checks
