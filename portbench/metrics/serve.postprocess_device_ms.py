"""Device milliseconds a call spends in kernels and copies launched inside
the postprocess (decode, top-k, NMS rounds), averaged over the traced
calls."""


def read(m):
    events = m.trace.launched_in("postprocess")
    return m.trace.busy_s(events) / m.calls * 1e3 if events else None
