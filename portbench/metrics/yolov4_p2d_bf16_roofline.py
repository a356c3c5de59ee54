"""YOLOv4's padded-2D convs' share of their roofline: the CSP split pairs
(one launch each), transitions and fuses, the neck's and heads' 1x1s and
3x3s and the detection convs, their bound at the cell's shapes
(portbench/counts_yolov4.py), times the traced calls, over the device time
of the padded-2D kernels with bf16 input (by name), in %."""

from portbench.counts_yolov4 import roofline_pct

KERNEL = r"conv_p2d_kernel.*Bf16In"


def read(m):
    return roofline_pct(m, "p2d_bf16", KERNEL)
