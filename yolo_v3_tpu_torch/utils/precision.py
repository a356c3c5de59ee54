"""Full float32 precision for cuDNN convolutions and CUDA matmuls.

PyTorch runs a float32 convolution on cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits.  :func:`full_fp32` turns TF32 off inside a block and gives
the caller's settings back afterwards, also when the block raises.  It
covers the legacy switches and, where this torch has it, the
``fp32_precision`` API.  The legacy getters raise when the two APIs were
mixed (say cuDNN's conv and RNN flags differ); a switch that cannot be read
is left alone, and the ``fp32_precision`` switch beside it turns TF32 off.

:func:`tf32_conv` does the opposite for cuDNN convolutions alone: it allows
TF32 inside a block.  The plain version of the bf16 forward's stem and
downs uses it for convolutions whose fp32 operands hold bf16 values, which
TF32 represents exactly, so the products are exact and the sums fp32 (the
tensor cores truncate a long sum, so the caller keeps each one short:
``ops/conv_down.py::TF32_K_CHANNELS``).
"""

from __future__ import annotations

import contextlib

import torch


def _switches():
    """(getter, setter, off value, on value, whether it is a convolution
    switch) of every switch, the legacy ones first, so that restoring in
    this order leaves the detailed new-API values last."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def attr(obj, name, off, on, conv):
        return (lambda: getattr(obj, name), lambda v: setattr(obj, name, v),
                off, on, conv)

    out = [attr(cudnn, "allow_tf32", False, True, True),
           # the legacy matmul switch: allow_tf32 reads "not highest"
           (torch.get_float32_matmul_precision, torch.set_float32_matmul_precision,
            "highest", "high", False)]
    if hasattr(cudnn, "conv"):
        out.append(attr(cudnn.conv, "fp32_precision", "ieee", "tf32", True))
    try:
        matmul.fp32_precision
    except (AttributeError, RuntimeError):
        pass
    else:
        out.append(attr(matmul, "fp32_precision", "ieee", "tf32", False))
    return out


@contextlib.contextmanager
def _scoped(values):
    """Set each readable switch to ``values(switch)`` (None: leave it) inside
    the block; the caller's values come back afterwards."""
    saved = []
    for sw in _switches():
        get, set_ = sw[0], sw[1]
        try:
            saved.append((set_, get(), values(sw)))
        except RuntimeError:      # a legacy getter after mixed APIs
            pass
    try:
        for set_, _, value in saved:
            if value is not None:
                set_(value)
        yield
    finally:
        for set_, value, _ in saved:
            set_(value)


def full_fp32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block."""
    return _scoped(lambda sw: sw[2])


def tf32_conv():
    """TF32 allowed for cuDNN convolutions (only) inside the block."""
    return _scoped(lambda sw: sw[3] if sw[4] else None)
