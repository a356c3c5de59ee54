"""The whole forward's share of the card's dense peak in the precision the
configuration serves (bf16 989 TFLOP/s, int8 1979 TOP/s): the operations of
the 75 convs at the input size (65.864 GFLOP an image at 416), times the
images completed in the traced slice, over the slice's seconds, in %."""

from portbench.counts import PEAK_OPS, forward_flops


def read(m):
    cfg = m.cfg
    ops = forward_flops(cfg["blocks"], cfg["classes"], cfg["input_size"]) * m.images
    return 100.0 * ops / (m.trace.window_s() * PEAK_OPS[cfg["precision"]])
