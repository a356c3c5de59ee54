"""Fused Darknet residual block: the port of
``yolo_v3_tpu/ops/pallas_kernels.py::fused_res_block``.

    out = y + leaky(conv3x3(leaky(conv1x1(y) + b1)) + b2)

on NHWC ``y`` with HWIO weights, SAME padding, LeakyReLU(0.1) and fp32
accumulation.  Rounding points follow the reference XLA chain
(``darknet._conv_bias_leaky`` twice, then ``y + r``): conv1's activation is
rounded to ``y.dtype``, conv2's activation is rounded to ``y.dtype`` and then
added to ``y`` in that dtype.  The 3x3's zero padding applies to conv1's
output (out-of-image ``mid`` is 0, not ``leaky(b1)``).  ``act="mish"`` puts
Mish in place of leaky on both convs (YOLOv4's CSPDarknet53 blocks,
``ops/activations.py``; bf16 kernel only), for any ``Cmid``, ``C`` included.

:func:`fused_res_block` launches the CUDA kernel (``csrc/fused_res_block.cu``)
for a CUDA tensor and uses the plain version :func:`fused_res_block_ref` for a
CPU tensor, because there is no kernel to run there.

The fp32 kernel takes each product as three TF32 products (3xTF32: lo*hi +
hi*lo + hi*hi, fp32 accumulation, in partial sums of ``F32_KPART`` steps of
32 K added in plain fp32).  Its weights come split by :func:`split_tf32`
into hi and lo planes, zero-padded and K-major (:func:`tf32_weights`, made
once and cached on the weight tensor); it splits the activations itself,
the same way.  The bf16 kernel takes its weights K-major and zero-padded
(:func:`bf16_weights`, cached the same way), so either dtype holds a second
copy of the residual-block weights on the card.  :func:`plan` reports the
tile geometry, split and cluster the kernel picks for a shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import _build
from yolo_v3_tpu_torch.ops import activations as A
from yolo_v3_tpu_torch.utils.precision import full_fp32

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the fp32 kernel's padding of its weight operands (FBK and FMGRAN in the
# source: K per step, and the mid channels of one chunk of conv2's K)
_F32_K1 = 32
_F32_MGRAN = 32
# steps of K = 32 a partial sum spans (FKPART in the source)
F32_KPART = 1
# the bf16 kernel's: K per pipeline step (BK) and the mid padding (BMGRAN)
_BF16_K = 64
_BF16_MGRAN = 16


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


def fused_res_block_ref(y, w1, b1, w2, b2, act="leaky"):
    """Plain PyTorch version: fp32 convolutions (TF32 off) with the kernel's
    rounding points.  ``y`` [B, H, W, C]; ``w1`` [C, Cmid] or [1, 1, C, Cmid];
    ``w2`` [3, 3, Cmid, C]; ``act`` "leaky" or "mish"; returns [B, H, W, C]
    in ``y.dtype``."""
    w1 = _check_shapes(y, w1, b1, w2, b2)
    dt = y.dtype
    x = y.float().permute(0, 3, 1, 2)                      # NCHW view
    k1 = w1.float().t()[:, :, None, None]                  # [Cmid, C, 1, 1]
    k2 = w2.float().permute(3, 2, 0, 1)                    # OIHW
    with full_fp32():
        mid = A.apply(F.conv2d(x, k1) + b1.float()[:, None, None], act).to(dt)
        # padding=1 zero-pads conv1's OUTPUT, as the reference does
        r = A.apply(F.conv2d(mid.float(), k2, padding=1)
                    + b2.float()[:, None, None], act).to(dt)
    return y + r.permute(0, 2, 3, 1)


def split_tf32(x: torch.Tensor):
    """fp32 ``x`` -> (hi, lo), both TF32 values (the low 13 of the 23 mantissa
    bits zero), with ``hi + lo`` = ``x`` within 2^-22 |x|.  Each part is
    rounded to nearest, ties away from zero: PTX ``cvt.rna.tf32.f32``, which
    the kernel applies to the activations."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _cached_layout(w1: torch.Tensor, w2: torch.Tensor, attr: str, make):
    """``make(w1, w2)``, cached on ``w1`` as ``attr`` until either weight
    moves or is written in place.  An inference tensor has no version
    counter, so nothing shows that it was written: with one, the layout is
    made anew on every call."""
    if w1.is_inference() or w2.is_inference():
        return make(w1, w2)
    key = (w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
    cached = getattr(w1, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, *make(w1, w2))
        setattr(w1, attr, cached)
    return cached[1:]


def _tf32_layout(w1, w2):
    c, cmid = w1.shape[-2:]
    mpad, cp = _pad_to(cmid, _F32_MGRAN), _pad_to(c, _F32_K1)
    w1t = w1.new_zeros(mpad, cp, dtype=torch.float32)
    w1t[:cmid, :c] = w1.reshape(c, cmid).t()
    w2t = w2.new_zeros(c, 9, mpad, dtype=torch.float32)
    w2t[:, :, :cmid] = w2.reshape(9, cmid, c).permute(2, 0, 1)
    # [co, chunk, tap, 32 mid channels]: K chunk-major, as conv2 steps through it
    w2k = w2t.reshape(c, 9, mpad // _F32_MGRAN, _F32_MGRAN).permute(0, 2, 1, 3)
    return (torch.stack(split_tf32(w1t)),
            torch.stack(split_tf32(w2k.reshape(c, 9 * mpad))))


def tf32_weights(w1: torch.Tensor, w2: torch.Tensor):
    """The fp32 kernel's weight operands: ``w1`` [C, Cmid] and ``w2`` [3, 3,
    Cmid, C] split by :func:`split_tf32` into hi and lo planes, K-major and
    zero-padded: w1p [2, Mpad, Cp] (plane, mid channel m, input channel k:
    ``w1[k, m]``) and w2p [2, C, 9 * Mpad] (plane, output channel co, then K
    chunk-major: column ``(kc * 9 + t) * 32 + j`` holds ``w2[t // 3, t % 3,
    kc * 32 + j, co]``), Mpad = Cmid rounded up to 32, Cp = C rounded up to
    32.  Made once and cached on ``w1`` until either weight moves or is
    written in place."""
    return _cached_layout(w1, w2, "_tf32_weights", _tf32_layout)


def _bf16_layout(w1, w2):
    c, cmid = w1.shape[-2:]
    mpad, cp = _pad_to(cmid, _BF16_MGRAN), _pad_to(c, _BF16_K)
    w1k = w1.new_zeros(mpad, cp)
    w1k[:cmid, :c] = w1.reshape(c, cmid).t()
    w2t = w2.new_zeros(c, 9, mpad)
    w2t[:, :, :cmid] = w2.reshape(9, cmid, c).permute(2, 0, 1)
    w2k = w2.new_zeros(c, _pad_to(9 * mpad, _BF16_K))
    w2k[:, :9 * mpad] = w2t.reshape(c, 9 * mpad)
    return w1k, w2k


def bf16_weights(w1: torch.Tensor, w2: torch.Tensor):
    """The bf16 kernel's weight operands, K-major and zero-padded: w1k
    [Mpad, Cp] (row m is ``w1[:, m]``) and w2k [C, K2p] (row co holds
    ``w2[t // 3, t % 3, m, co]`` at column ``t * Mpad + m``, taps in
    row-major order), Mpad = Cmid rounded up to 16, Cp = C rounded up to 64,
    K2p = 9 * Mpad rounded up to 64.  Made once and cached on ``w1`` until
    either weight moves or is written in place."""
    return _cached_layout(w1, w2, "_bf16_weights", _bf16_layout)


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """(the C function ``yolo_fused_res_block_<name>``, the error-string
    function); "f32", "f32_kpart" and "bf16" (an activation code last)
    launch, "plan" plans."""
    lib = _build.load("fused_res_block")
    fn = getattr(lib, f"yolo_fused_res_block_{name}")
    if name == "plan":
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    else:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * (5 if name == "f32" else 6)
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.yolo_cuda_error_string


_PLAN_KEYS = ("variant", "splits", "cluster", "flat", "tiles", "mid_rows", "mid_per_block",
              "co_per_block", "smem")


def plan(b: int, h: int, w: int, c: int, cmid: int,
         dtype: torch.dtype = torch.float32, act: str = "leaky") -> dict:
    """The launch plan of the ``dtype`` kernel (with activation ``act``) for
    [b, h, w, c] with ``cmid`` mid channels on the current CUDA device:
    ``variant`` (channels a
    warpgroup), ``splits`` (blocks a tile's output channels are split
    over), ``cluster``, ``geometry`` ("flat": 64 pixels in raster order;
    "8x8"), ``tiles`` an image, ``mid_rows`` a tile, ``mid_per_block`` and
    ``co_per_block`` (mid and output channels of a block), ``smem`` (shared
    bytes a block)."""
    fn, err_str = _kernel("plan")
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = fn(int(dtype == torch.bfloat16), A.CODES[act], b, h, w, c, cmid, out)
    if rc != 0:
        raise RuntimeError(f"fused_res_block: no {_KERNEL_DTYPES[dtype]} launch for "
                           f"{(b, h, w, c, cmid)}: {err_str(rc).decode()}")
    got = dict(zip(_PLAN_KEYS, out))
    got["geometry"] = "flat" if got.pop("flat") else "8x8"
    return got


def cluster_size(b: int, h: int, w: int, c: int, cmid: int,
                 dtype: torch.dtype = torch.float32) -> int:
    """The thread-block cluster the ``dtype`` kernel launches for [b, h, w, c]
    with ``cmid`` mid channels on the current CUDA device: the number of
    blocks of one tile that split its conv1 between them (1: none)."""
    return plan(b, h, w, c, cmid, dtype)["cluster"]


def fused_res_block(y, w1, b1, w2, b2, act="leaky"):
    """Fused residual block on [B, H, W, C].

    A CUDA ``y`` runs the hand-written kernel (every operand on the same
    card, one dtype, float32 or bfloat16, contiguous; y 16-byte aligned with
    C % 4 == 0 in float32, C % 8 == 0 in bfloat16; ``act`` "mish" in
    bfloat16 only) or raises; a CPU ``y`` runs :func:`fused_res_block_ref`.
    ``fused_res_block.launches`` counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_res_block_ref(y, w1, b1, w2, b2, act)
    return _launch(y, w1, b1, w2, b2, act=act)


def _launch(y, w1, b1, w2, b2, kpart=None, act="leaky"):
    """The kernel on CUDA operands; ``kpart`` (fp32 only) sets the steps of
    K = 32 a partial sum spans (default ``F32_KPART``)."""
    if y.device.type != "cuda":
        raise ValueError(f"fused_res_block: unsupported device {y.device}")
    w1_arg, w1 = w1, _check_shapes(y, w1, b1, w2, b2)
    operands = (y, w1, b1, w2, b2)
    if any(t.device != y.device for t in operands):
        raise ValueError("fused_res_block: all operands must be on one device")
    if y.dtype not in _KERNEL_DTYPES or any(t.dtype != y.dtype for t in operands):
        raise TypeError(
            "fused_res_block: operands must share one dtype, float32 or "
            f"bfloat16; got {[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fused_res_block: operands must be contiguous")
    if y.shape[3] * y.element_size() % 16 or y.data_ptr() % 16:
        raise ValueError("fused_res_block: the kernel reads y in 16-byte rows: C must be a "
                         f"multiple of {16 // y.element_size()} (got {y.shape[3]}) and y "
                         "16-byte aligned")
    if kpart is not None and (y.dtype != torch.float32 or kpart < 1):
        raise ValueError(f"fused_res_block: kpart {kpart} (fp32 only, >= 1)")
    if act not in ("leaky", "mish") or (act == "mish" and y.dtype != torch.bfloat16):
        raise ValueError(f"fused_res_block: act {act!r} (leaky; mish in bfloat16 only)")
    b, h, w, c = y.shape
    cmid = w1.shape[1]
    out = torch.empty_like(y)
    name = _KERNEL_DTYPES[y.dtype] + ("_kpart" if kpart is not None else "")
    # f32_kpart: the partial depth; bf16: the activation code
    extra = {"f32": (), "f32_kpart": (kpart,), "bf16": (A.CODES[act],)}[name]
    fn, err_str = _kernel(name)
    w1, w2 = (tf32_weights if y.dtype == torch.float32 else bf16_weights)(w1_arg, w2)
    ptrs = (y, w1, b1, w2, b2, out)
    with torch.cuda.device(y.device):
        rc = fn(*[t.data_ptr() for t in ptrs], b, h, w, c, cmid, *extra,
                torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_res_block kernel launch failed for y {tuple(y.shape)} "
            f"{y.dtype}: {err_str(rc).decode()}")
    fused_res_block.launches += 1
    return out


fused_res_block.launches = 0
