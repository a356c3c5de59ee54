"""Fused Darknet residual block: the port of
``yolo_v3_tpu/ops/pallas_kernels.py::fused_res_block``.

    out = y + leaky(conv3x3(leaky(conv1x1(y) + b1)) + b2)

on NHWC ``y`` with HWIO weights, SAME padding, LeakyReLU(0.1) and fp32
accumulation.  Rounding points follow the reference XLA chain
(``darknet._conv_bias_leaky`` twice, then ``y + r``): conv1's activation is
rounded to ``y.dtype``, conv2's activation is rounded to ``y.dtype`` and then
added to ``y`` in that dtype.  The 3x3's zero padding applies to conv1's
output (out-of-image ``mid`` is 0, not ``leaky(b1)``).

:func:`fused_res_block` launches the CUDA kernel (``csrc/fused_res_block.cu``)
for a CUDA tensor and uses the plain version :func:`fused_res_block_ref` for a
CPU tensor, because there is no kernel to run there.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import _build

LEAKY_SLOPE = 0.1

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _split_w1(w1: torch.Tensor, c: int) -> torch.Tensor:
    """[1, 1, C, Cmid] or [C, Cmid] -> [C, Cmid]."""
    if w1.dim() == 4:
        if tuple(w1.shape[:3]) != (1, 1, c):
            raise ValueError(f"w1 must be [1, 1, {c}, Cmid], got {tuple(w1.shape)}")
        w1 = w1.reshape(c, w1.shape[3])
    if w1.dim() != 2 or w1.shape[0] != c:
        raise ValueError(f"w1 must be [{c}, Cmid], got {tuple(w1.shape)}")
    return w1


def _check_shapes(y, w1, b1, w2, b2):
    if y.dim() != 4:
        raise ValueError(f"y must be [B, H, W, C], got {tuple(y.shape)}")
    c = y.shape[3]
    w1 = _split_w1(w1, c)
    cmid = w1.shape[1]
    if tuple(w2.shape) != (3, 3, cmid, c):
        raise ValueError(f"w2 must be [3, 3, {cmid}, {c}], got {tuple(w2.shape)}")
    if tuple(b1.shape) != (cmid,) or tuple(b2.shape) != (c,):
        raise ValueError(
            f"biases must be [{cmid}] and [{c}], got {tuple(b1.shape)} and "
            f"{tuple(b2.shape)}")
    return w1


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, LEAKY_SLOPE * x)


def fused_res_block_ref(y, w1, b1, w2, b2):
    """Plain PyTorch version: fp32 convolutions with the kernel's rounding
    points.  ``y`` [B, H, W, C]; ``w1`` [C, Cmid] or [1, 1, C, Cmid];
    ``w2`` [3, 3, Cmid, C]; returns [B, H, W, C] in ``y.dtype``."""
    w1 = _check_shapes(y, w1, b1, w2, b2)
    dt = y.dtype
    x = y.float().permute(0, 3, 1, 2)                      # NCHW view
    k1 = w1.float().t()[:, :, None, None]                  # [Cmid, C, 1, 1]
    mid = _leaky(F.conv2d(x, k1) + b1.float()[:, None, None]).to(dt)
    # padding=1 zero-pads conv1's OUTPUT, as the reference does
    k2 = w2.float().permute(3, 2, 0, 1)                    # OIHW
    r = _leaky(F.conv2d(mid.float(), k2, padding=1)
               + b2.float()[:, None, None]).to(dt)
    return y + r.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _kernel(suffix: str):
    lib = _build.load("fused_res_block")
    fn = getattr(lib, f"yolo_fused_res_block_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.yolo_cuda_error_string


def fused_res_block(y, w1, b1, w2, b2):
    """Fused residual block on [B, H, W, C].

    A CUDA ``y`` runs the hand-written kernel (every operand on the same
    card, one dtype, float32 or bfloat16, contiguous) or raises; a CPU ``y``
    runs :func:`fused_res_block_ref`.  ``fused_res_block.launches`` counts
    kernel launches.
    """
    if y.device.type == "cpu":
        return fused_res_block_ref(y, w1, b1, w2, b2)
    if y.device.type != "cuda":
        raise ValueError(f"fused_res_block: unsupported device {y.device}")
    w1 = _check_shapes(y, w1, b1, w2, b2)
    operands = (y, w1, b1, w2, b2)
    if any(t.device != y.device for t in operands):
        raise ValueError("fused_res_block: all operands must be on one device")
    if y.dtype not in _KERNEL_DTYPES or any(t.dtype != y.dtype for t in operands):
        raise TypeError(
            "fused_res_block: operands must share one dtype, float32 or "
            f"bfloat16; got {[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fused_res_block: operands must be contiguous")
    b, h, w, c = y.shape
    out = torch.empty_like(y)
    fn, err_str = _kernel(_KERNEL_DTYPES[y.dtype])
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), b, h, w, c, w1.shape[1],
                torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_res_block kernel launch failed for y {tuple(y.shape)} "
            f"{y.dtype}: {err_str(rc).decode()}")
    fused_res_block.launches += 1
    return out


fused_res_block.launches = 0
