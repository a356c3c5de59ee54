"""The int8 convs' share of their roofline (the blocks of stages 1-4 and
the heads: 36 1x1 and 31 3x3 a forward): their bound at the cell's shapes
(portbench/counts.py), times the traced calls, over the device time of the
padded-2D kernels with int8 input (by name), in %."""

from portbench.counts import roofline_pct

KERNEL = r"conv_p2d_kernel.*I8In"


def read(m):
    return roofline_pct(m, "p2d_int8", KERNEL)
