"""The bf16 residual blocks' share of their roofline: the bound of the 23
blocks' work at the cell's shapes (portbench/counts.py), times the traced
calls, over the device time of the kernels that do it (by name), in %."""

from portbench.counts import roofline_pct

KERNEL = r"res_block_bf16_kernel"


def read(m):
    return roofline_pct(m, "res_block_bf16", KERNEL)
