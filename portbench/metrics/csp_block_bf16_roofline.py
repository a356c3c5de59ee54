"""YOLOv4's 23 CSP residual blocks' share of their roofline: the bound of
their work at the cell's shapes (portbench/counts_yolov4.py), times the
traced calls, over the device time of the residual-block kernel's Mish
variant (by name), in %; None where no such kernel ran."""

from portbench.counts_yolov4 import roofline_pct

KERNEL = r"res_block_bf16_kernel<[^>]*ActMish"


def read(m):
    return roofline_pct(m, "csp_block_bf16", KERNEL)
