"""The bf16 head, detection and up convs' share of their roofline (14 1x1
and 9 3x3 a forward): their bound at the cell's shapes
(portbench/counts.py), times the traced calls, over the device time of the
padded-2D kernels with bf16 input (by name), in %."""

from portbench.counts import roofline_pct

KERNEL = r"conv_p2d_kernel.*Bf16In"


def read(m):
    return roofline_pct(m, "p2d_bf16", KERNEL)
