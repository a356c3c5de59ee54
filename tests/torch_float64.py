"""Evaluate the port's training code in float64 (shared by the step tests
and the data-parallel worker, which must not import JAX)."""

import contextlib

import torch


@contextlib.contextmanager
def port_in_float64():
    """The port's step on float64 trees and batches, evaluated in float64:
    ``Tensor.float()``, which the port calls for its BN math, loss and
    clip, leaves a float64 tensor as it is inside the block."""
    to_float = torch.Tensor.float

    def keep_float64(self, *args, **kw):
        return self if self.dtype == torch.float64 else to_float(self, *args, **kw)

    torch.Tensor.float = keep_float64
    try:
        yield
    finally:
        torch.Tensor.float = to_float
