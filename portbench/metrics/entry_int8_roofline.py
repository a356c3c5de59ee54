"""The int8 entry's share of its roofline (stem, stage-0 down and block,
stage-1 down, with the image codes in and the stage-1 input out): its bound
at the cell's shapes (portbench/counts.py), times the traced calls, over
the device time of the entry kernel (by name), in %."""

from portbench.counts import roofline_pct

KERNEL = r"fused_entry_kernel"


def read(m):
    return roofline_pct(m, "entry_int8", KERNEL)
