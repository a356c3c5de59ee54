"""YOLOv4's whole forward as a share of the card's dense bf16 peak (989
TFLOP/s): the operations of its 110 convs at the input size (128.39 GFLOP an
image at 608, portbench/counts_yolov4.py), times the images completed in
the traced slice, over the slice's seconds, in %."""

from portbench.counts_yolov4 import PEAK_OPS, forward_flops


def read(m):
    cfg = m.cfg
    ops = forward_flops(cfg["blocks"], cfg["classes"], cfg["input_size"]) * m.images
    return 100.0 * ops / (m.trace.window_s() * PEAK_OPS[cfg["precision"]])
