"""Host milliseconds a call spends in ``Detector.preprocess`` (the
letterbox of each image on the card and the uploads), from the benchmark's
span around it, averaged over the traced calls."""


def read(m):
    return m.trace.span_s("preprocess") / m.calls * 1e3
