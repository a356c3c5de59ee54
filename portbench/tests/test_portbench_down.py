"""The stem and stride-2 convs' count and their roofline reader
(``counts_down.py``, ``metrics/down_bf16_roofline.py``) on synthetic
traces: 6 launches of the kernel in a YOLOv3 call and 8 in a YOLOv4 call
give the hand-computed share; a trace without the kernel gives no value.
No number here is a device metric."""

import types

import pytest

from portbench import core, counts_down
from portbench.trace import Trace

NAME = "void (anonymous namespace)::conv_down_bf16_kernel<false, 2, 128, 1, true>(...)"
PEAK, HBM = 989e12, 3.35e12


def _bound_by_hand(shapes, batch):
    """sum over (cin, cout, output h, stride) of max(ops / peak, bytes / HBM):
    bf16 input, 3x3 weight and output, float32 bias."""
    total = 0.0
    for cin, cout, h, s in shapes:
        ops = 2.0 * batch * h * h * cout * 9 * cin
        nbytes = (2 * batch * (h * s) ** 2 * cin + 2 * 9 * cin * cout + 2 * batch * h * h * cout
                  + 4 * cout)
        total += max(ops / PEAK, nbytes / HBM)
    return total


YOLOV3 = [(3, 32, 416, 1), (32, 64, 208, 2), (64, 128, 104, 2), (128, 256, 52, 2),
          (256, 512, 26, 2), (512, 1024, 13, 2)]
YOLOV4 = [(3, 32, 608, 1), (32, 64, 304, 2), (64, 128, 152, 2), (128, 256, 76, 2),
          (256, 512, 38, 2), (512, 1024, 19, 2), (128, 256, 38, 2), (256, 512, 19, 2)]


def _inputs(config, kernels, calls=2):
    """A traced slice of ``calls`` calls holding ``kernels`` (name, us)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "portbench.slice", "ts": 0.0,
               "dur": 1e6}]
    t = 10.0
    for name, us in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": us})
        t += us + 1
    cfg = core.load_json(core.BENCH_DIR / "configs" / f"{config}.json")
    return types.SimpleNamespace(cfg=cfg, mix={"batch": 32}, trace=Trace(events), calls=calls)


def _read(inputs):
    mod = core.load_module(core.BENCH_DIR / "metrics" / "down_bf16_roofline.py", "down")
    return mod.read(inputs)


@pytest.mark.parametrize("config,shapes", [("yolov3-416-bf16", YOLOV3),
                                           ("yolov4-608-bf16", YOLOV4)],
                         ids=["yolov3", "yolov4"])
def test_down_roofline_reads_the_kernel(config, shapes):
    cfg = core.load_json(core.BENCH_DIR / "configs" / f"{config}.json")
    layers = counts_down.down_layers(cfg)
    assert [(l["cin"], l["cout"], l["h"], l["stride"]) for l in layers] == shapes
    # one call's launches (6 or 8) of 250 us each, two calls traced
    kernels = [(NAME, 250.0)] * (2 * len(shapes)) + [("void conv_p2d_kernel<Bf16In>", 900.0)]
    want = 100.0 * _bound_by_hand(shapes, 32) * 2 / (2 * len(shapes) * 250e-6)
    assert _read(_inputs(config, kernels)) == pytest.approx(want, rel=1e-12)
    assert counts_down.down_bound_s(cfg, 32) == pytest.approx(_bound_by_hand(shapes, 32),
                                                              rel=1e-12)


def test_down_roofline_is_silent_without_the_kernel():
    kernels = [("void conv_p2d_kernel<Bf16In>", 900.0),
               ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32", 400.0)]
    assert _read(_inputs("yolov3-416-bf16", kernels)) is None
