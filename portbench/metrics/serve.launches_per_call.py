"""Kernel launches a call makes (runtime and driver launch calls in the
profiler), averaged over the traced calls."""

from portbench.trace import LAUNCH_CALLS


def read(m):
    n = len(m.trace.runtime_in_window(LAUNCH_CALLS))
    return n / m.calls if n else None
