"""Device milliseconds a call spends in kernels and copies launched inside
the program's ``yolo.neck`` span (YOLOv4's SPP, top-down and bottom-up
paths and its three heads; the union of their intervals), averaged over the
traced calls; None where the program marks no such span."""


def read(m):
    fn = getattr(m.trace, "program_device_ms", None)
    return fn("neck", m.calls) if fn is not None else None
