"""The bf16 stem and stride-2 convs' share of their roofline: their bound at
the cell's shapes (portbench/counts_down.py: the stem and 5 downs of
YOLOv3, the stem, 5 Mish downs and PANet's 2 leaky stride-2 convs of
YOLOv4), times the traced calls, over the device time of the stem / down
kernel (by name), in %; None where no such kernel ran (a program that
runs these convs on cuDNN).  It is also the kernel's counter: a call
launches it exactly 6 times in YOLOv3 and 8 times in YOLOv4."""

from portbench.counts_down import roofline_pct

KERNEL = r"conv_down_bf16_kernel"


def read(m):
    return roofline_pct(m, KERNEL)
