"""Device milliseconds a call spends in kernels and copies launched inside
the model's forward (the union of their intervals), averaged over the
traced calls."""


def read(m):
    events = m.trace.launched_in("forward")
    return m.trace.busy_s(events) / m.calls * 1e3 if events else None
