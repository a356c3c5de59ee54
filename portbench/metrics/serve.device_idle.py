"""Share of the traced slice in which no kernel, copy or fill ran on the
device (one less the union of device intervals over the slice), in %."""


def read(m):
    return 100.0 * (1.0 - m.trace.busy_s() / m.trace.window_s())
