"""The activations of the kernels' epilogues, in their plain PyTorch form.

The kernels take an activation code (``CODES``): none, LeakyReLU(0.1)
(YOLOv3 everywhere; YOLOv4's neck and heads) or Mish (YOLOv4's backbone).
Mish is ``x * tanh(softplus(x))``, computed as the kernels compute it, in
float32 on the accumulator::

    n = e^x;  mish(x) = x * (n^2 + 2n) / (n^2 + 2n + 2);  x above 20

(20 is darknet's softplus threshold).  The kernels use the fast exponential
and division, so they agree with :func:`mish` to a few float32 ulps, inside
one bf16 rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.1
MISH_THRESHOLD = 20.0
# the kernels' activation codes
CODES = {"linear": 0, "leaky": 1, "mish": 2}


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, LEAKY_SLOPE * x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish of a float32 ``x`` in the kernels' form (module docstring)."""
    n = torch.exp(torch.clamp(x, max=MISH_THRESHOLD))
    t = n * (n + 2)
    return torch.where(x > MISH_THRESHOLD, x, x * t / (t + 2))


def mish_(x: torch.Tensor) -> torch.Tensor:
    """Mish in place in one pass (``F.mish``: ``x * tanh(log1p(e^x))``, within
    float32 rounding of :func:`mish`): the cuDNN convs' (YOLOv4's stem and
    downs), whose float32 outputs are the forward's largest tensors."""
    return F.mish(x, inplace=True)


def apply(x: torch.Tensor, act: str) -> torch.Tensor:
    """``x`` through the activation named ``act`` (a key of ``CODES``)."""
    if act == "leaky":
        return leaky(x)
    if act == "mish":
        return mish(x)
    if act == "linear":
        return x
    raise ValueError(f"unknown activation {act!r}; expected one of {sorted(CODES)}")
