"""Fused int8 entry: stem .. stage 1's downsample in one kernel, the port of
``yolo_v3_tpu/ops/entry_kernel.py::fused_entry``.

In the 2x2 space-to-depth domain (the ``s2d`` convs of the quantized tree,
all int8 in, int32 accumulation, the int8 epilogue of
:func:`~yolo_v3_tpu_torch.ops.fused_conv.epilogue_ref`)::

    stem    3x3 VALID             [B, 2h+2, 2w+2, 12] -> [B, 2h, 2w, 128]
    down0   3x3 stride 2, pad 1                       -> [B, h, w, 256]
    res0_1  1x1                                       -> [B, h, w, 128]
    res0_2  3x3 pad 1, + down0 * res_scale            -> [B, h, w, 256]
    down1   2x2 pad (1, 0)                            -> [B, h, w, 128]

(h = w = 104 at 416.)  :func:`fused_entry` launches the CUDA kernel
(``csrc/fused_entry.cu``) for a CUDA tensor, which keeps every intermediate
in shared memory, and runs the plain chain :func:`fused_entry_ref` for a
CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from yolo_v3_tpu_torch.ops import _build
from yolo_v3_tpu_torch.ops.fused_conv import conv_i8_nhwc, k_major

CONVS = ("stem", "down0", "res0_1", "res0_2", "down1")
# (kh, kw, cin, cout) of each s2d conv: YOLOv3's 32- and 64-channel entry
# in the 2x2 space-to-depth domain
SHAPES = {"stem": (3, 3, 12, 128), "down0": (3, 3, 128, 256),
          "res0_1": (1, 1, 256, 128), "res0_2": (3, 3, 128, 256),
          "down1": (2, 2, 256, 128)}


def _w4(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(1, 1, *w.shape) if w.dim() == 2 else w


def fused_entry_ref(xb: torch.Tensor, qs2d: Dict, res_scale: float) -> torch.Tensor:
    """Plain version of :func:`fused_entry`: the five convs one after the
    other (the JAX XLA chain of ``tests/test_entry_kernel.py::xla_entry``)."""
    def conv(name, x, **kw):
        p = qs2d[name]
        return conv_i8_nhwc(x, _w4(p["w"]), p["m"], p["b"], **kw)

    y = conv("stem", xb, padding=((0, 0), (0, 0)))
    y = conv("down0", y, stride=2, padding=((1, 1), (1, 1)))
    r = conv("res0_1", y, padding=((0, 0), (0, 0)))
    r = conv("res0_2", r, padding=((1, 1), (1, 1)), residual=y, res_scale=res_scale)
    return conv("down1", r, padding=((1, 0), (1, 0)))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("fused_entry")
    fn = lib.yolo_fused_entry_i8
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.yolo_cuda_error_string


def fused_entry(xb: torch.Tensor, qs2d: Dict, res_scale: float) -> torch.Tensor:
    """The int8 entry on ``xb`` [B, 2h+2, 2w+2, 12] int8 (the space-to-depth
    image) with the quantized tree's ``s2d`` convs; returns [B, h, w, 128]
    int8.  A CUDA ``xb`` runs the kernel or raises; a CPU one runs
    :func:`fused_entry_ref`.  ``fused_entry.launches`` counts kernel
    launches."""
    if xb.device.type == "cpu":
        return fused_entry_ref(xb, qs2d, res_scale)
    if xb.device.type != "cuda":
        raise ValueError(f"fused_entry: unsupported device {xb.device}")
    if xb.dtype != torch.int8:
        raise TypeError(f"fused_entry: xb must be int8, got {xb.dtype}")
    if (xb.dim() != 4 or xb.shape[3] != 12 or xb.shape[1] % 2 or xb.shape[2] % 2
            or xb.shape[1] < 4 or xb.shape[2] < 4):
        raise ValueError(f"fused_entry: xb must be [B, 2h+2, 2w+2, 12], got "
                         f"{tuple(xb.shape)}")
    operands = [xb]
    for name in CONVS:
        p = qs2d[name]
        w, m, b = _w4(p["w"]), p["m"], p["b"]
        cout = SHAPES[name][3]
        if tuple(w.shape) != SHAPES[name] or w.dtype != torch.int8:
            raise ValueError(f"fused_entry: {name} weight must be int8 "
                             f"{SHAPES[name]}, got {w.dtype} {tuple(w.shape)}")
        if (tuple(m.shape) != (cout,) or tuple(b.shape) != (cout,)
                or m.dtype != torch.float32 or b.dtype != torch.float32):
            raise ValueError(f"fused_entry: {name} m and b must be float32 [{cout}]")
        operands += [w, m, b]
    if any(t.device != xb.device for t in operands):
        raise ValueError("fused_entry: all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fused_entry: operands must be contiguous")
    if any(t.data_ptr() % 4 for t in operands):
        raise ValueError("fused_entry: operands must start on a 4-byte boundary")
    # the kernel reads each weight K-major, [cout, kh*kw*cin] (cached on it)
    for i, name in enumerate(CONVS):
        w = operands[1 + 3 * i]
        operands[1 + 3 * i] = k_major(qs2d[name]["w"], w.reshape(-1, w.shape[-1]))
    bsz, hb, wb, _ = xb.shape
    out = torch.empty((bsz, (hb - 2) // 2, (wb - 2) // 2, 128), dtype=torch.int8,
                      device=xb.device)
    fn, err_str = _kernel()
    with torch.cuda.device(xb.device):
        rc = fn(*[t.data_ptr() for t in operands], out.data_ptr(), float(res_scale),
                bsz, hb, wb, torch.cuda.current_stream(xb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_entry kernel launch failed for xb "
                           f"{tuple(xb.shape)}: {err_str(rc).decode()}")
    fused_entry.launches += 1
    return out


fused_entry.launches = 0
