"""Times a call makes the host wait for the device: stream, device and event
synchronisations and synchronous copies, from the profiler's runtime
calls, averaged over the traced calls."""

from portbench.trace import SYNC_CALLS


def read(m):
    return len(m.trace.runtime_in_window(SYNC_CALLS)) / m.calls
