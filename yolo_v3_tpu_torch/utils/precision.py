"""Full float32 precision for cuDNN convolutions and CUDA matmuls.

PyTorch runs a float32 convolution on cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits.  :func:`full_fp32` turns TF32 off inside a block and gives
the caller's settings back afterwards, also when the block raises.  It
covers the legacy switches and, where this torch has it, the
``fp32_precision`` API.  The legacy getters raise when the two APIs were
mixed (say cuDNN's conv and RNN flags differ); a switch that cannot be read
is left alone, and the ``fp32_precision`` switch beside it turns TF32 off.
"""

from __future__ import annotations

import contextlib

import torch


def _switches():
    """(getter, setter, off value) of every switch, the legacy ones first, so
    that restoring in this order leaves the detailed new-API values last."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def attr(obj, name, off):
        return (lambda: getattr(obj, name), lambda v: setattr(obj, name, v), off)

    out = [attr(cudnn, "allow_tf32", False),
           # the legacy matmul switch: allow_tf32 reads "not highest"
           (torch.get_float32_matmul_precision, torch.set_float32_matmul_precision,
            "highest")]
    if hasattr(cudnn, "conv"):
        out.append(attr(cudnn.conv, "fp32_precision", "ieee"))
    try:
        matmul.fp32_precision
    except (AttributeError, RuntimeError):
        pass
    else:
        out.append(attr(matmul, "fp32_precision", "ieee"))
    return out


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block."""
    saved = []
    for get, set_, off in _switches():
        try:
            saved.append((set_, get(), off))
        except RuntimeError:      # a legacy getter after mixed APIs
            pass
    try:
        for set_, _, off in saved:
            set_(off)
        yield
    finally:
        for set_, value, _ in saved:
            set_(value)
