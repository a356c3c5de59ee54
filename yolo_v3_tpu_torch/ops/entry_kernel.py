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

The kernel walks bands of output rows, :data:`STEP` rows a step, in strips
of :data:`STRIP` output columns whose rings are :data:`RING_WIDTH` pixels
wide; :func:`plan_entry` mirrors its planner (the band height).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import _build
from yolo_v3_tpu_torch.ops.fused_conv import conv_i8_nhwc, k_major

CONVS = ("stem", "down0", "res0_1", "res0_2", "down1")
# (kh, kw, cin, cout) of each s2d conv: YOLOv3's 32- and 64-channel entry
# in the 2x2 space-to-depth domain
SHAPES = {"stem": (3, 3, 12, 128), "down0": (3, 3, 128, 256),
          "res0_1": (1, 1, 256, 128), "res0_2": (3, 3, 128, 256),
          "down1": (2, 2, 256, 128)}


# The kernel's geometry (csrc/fused_entry.cu): output columns a strip, ring
# row width (the strip and its 4 halo columns), output rows a step, and the
# dynamic shared memory of a block.
STRIP = 26
RING_WIDTH = STRIP + 4
STEP = 2
SMEM_BYTES = 231520


def band_steps(rows: int) -> int:
    """Steps of a band of ``rows`` output rows: the walk starts 3 rows above
    the band, so that every ring holds what its first row needs."""
    return -(-(rows + 4) // STEP)


def plan_entry(b: int, h: int, w: int, sms: int = 132) -> Dict[str, int]:
    """The geometry the kernel runs a [b, h, w] output with on a card of
    ``sms`` SMs (the C launcher's ``plan_band``): the band height with the
    least (waves of work items over the ``sms`` resident blocks) x (steps a
    band), then the least total steps, the lowest on a tie."""
    strips = -(-w // STRIP)
    best = None
    for hb in range(1, h + 1):
        units = b * -(-h // hb) * strips
        steps = band_steps(hb)
        key = (-(-units // sms) * steps, units * steps)
        if best is None or key < best[0]:
            best = (key, hb, units)
    _, hb, units = best
    return dict(strip=STRIP, step=STEP, band=hb, units=units, steps=band_steps(hb))


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
def _lib():
    lib = _build.load("fused_entry")
    args = [ctypes.c_void_p] * 17 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.yolo_fused_entry_i8.argtypes = args
    lib.yolo_fused_entry_i8.restype = ctypes.c_int
    # the forced-band entry takes the band first
    lib.yolo_fused_entry_band.argtypes = [ctypes.c_int] + args
    lib.yolo_fused_entry_band.restype = ctypes.c_int
    lib.yolo_fused_entry_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.yolo_fused_entry_plan.restype = ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def plan_on_device(b: int, h: int, w: int) -> Dict[str, int]:
    """The geometry the C launcher picks for a [b, h, w] output on the
    current device: strip, step, band and shared bytes a block."""
    geo = (ctypes.c_int * 4)()
    rc = _lib().yolo_fused_entry_plan(b, 2 * h + 2, 2 * w + 2, geo)
    if rc != 0:
        raise RuntimeError(f"fused_entry plan failed: "
                           f"{_lib().yolo_cuda_error_string(rc).decode()}")
    return dict(zip(("strip", "step", "band", "smem"), geo))


def stem_k128(w: torch.Tensor) -> torch.Tensor:
    """The stem's weight [3, 3, 12, 128] K-major with its 108 columns
    zero-padded to 128 (one 128-byte row a channel, as TMA loads it).
    Cached on ``w`` like :func:`~yolo_v3_tpu_torch.ops.fused_conv.k_major`
    (made anew for an inference tensor, which has no version counter)."""
    def make():
        return F.pad(w.reshape(108, 128).t(), (0, 20)).contiguous()

    if w.is_inference():
        return make()
    key = (w.data_ptr(), w._version)
    cached = getattr(w, "_k128", None)
    if cached is None or cached[0] != key:
        cached = (key, make())
        w._k128 = cached
    return cached[1]


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
    out = _launch(xb, qs2d, res_scale)
    fused_entry.launches += 1
    return out


def _launch(xb: torch.Tensor, qs2d: Dict, res_scale: float,
            band: Optional[int] = None) -> torch.Tensor:
    """Check the operands of a CUDA launch and run the kernel; ``band`` (1 ..
    h) overrides the planner's band height, so that the tests and
    ``scripts/entry_sweep.py`` can hold and time every geometry."""
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
    bsz, hb, wb, _ = xb.shape
    h = (hb - 2) // 2
    if band is not None and not 1 <= band <= h:
        raise ValueError(f"fused_entry: band must be in 1..{h}, got {band}")
    # the kernel reads each weight K-major, [cout, kh*kw*cin] (cached on it),
    # the stem's 108 columns padded to 128
    for i, name in enumerate(CONVS):
        w = operands[1 + 3 * i]
        operands[1 + 3 * i] = (stem_k128(qs2d[name]["w"]) if name == "stem" else
                               k_major(qs2d[name]["w"], w.reshape(-1, w.shape[-1])))
    if any(operands[1 + 3 * i].data_ptr() % 16 for i in range(len(CONVS))):
        raise ValueError("fused_entry: weights must start on a 16-byte boundary")
    out = torch.empty((bsz, h, (wb - 2) // 2, 128), dtype=torch.int8, device=xb.device)
    lib = _lib()
    args = ([t.data_ptr() for t in operands]
            + [out.data_ptr(), float(res_scale), bsz, hb, wb,
               torch.cuda.current_stream(xb.device).cuda_stream])
    with torch.cuda.device(xb.device):
        rc = (lib.yolo_fused_entry_i8(*args) if band is None
              else lib.yolo_fused_entry_band(band, *args))
    if rc != 0:
        raise RuntimeError(f"fused_entry kernel launch failed for xb "
                           f"{tuple(xb.shape)}: {lib.yolo_cuda_error_string(rc).decode()}")
    return out


fused_entry.launches = 0
