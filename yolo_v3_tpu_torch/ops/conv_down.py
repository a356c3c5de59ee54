"""The bf16 stem and stride-2 downsample convolutions of the folded forward:
conv, bias and activation with one rounding to bf16, on the hand-written
kernel (``csrc/conv_down.cu``) for a CUDA tensor.

A 3x3 conv of an NCHW (``channels_last``) bf16 batch by an OIHW bf16
weight, with SAME padding (``pad`` = 1) or, for a height-sharded stripe
that carries its halo rows, padding of W only (``pad`` = (0, 1))::

    y = act(conv(x, w) + bias)     float32 sums, bias and activation
    out = bf16(y)                  one rounding

as the reference's ``_conv_bias_leaky`` does.  ``act`` is ``leaky``
(LeakyReLU(0.1)), ``mish`` or ``linear`` (``ops/activations.py``).  The
kernel takes the stem (stride 1, 3 input channels) and the stride-2 downs
(input channels a multiple of 8), at even W and N % 8 == 0, and raises for
any other conv of a CUDA batch; a CPU tensor, and ``plain=True`` in the
model, run :func:`conv_down_ref`, the chunked TF32 path: cuDNN
float32 convs on the bf16 values (exact products in TF32) over chunks of
``TF32_K_CHANNELS`` input channels, partial sums, bias and activation in
float32, then the cast.

The kernel's sum is the tensor cores' float32 accumulator, added into a
second float32 sum every :data:`PROMOTE` K slots of 64 products a pixel
(the plain version's chunks of 64 channels x 9 taps), because the tensor
cores truncate a long sum (ROADMAP fact 1).  Its weight layout
(:func:`k_major`) is made once a weight and follows in-place writes.  Its
tile shape is planned per shape (:func:`plan_tiles`, which the C launcher
mirrors).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import _build
from yolo_v3_tpu_torch.ops import activations as A
from yolo_v3_tpu_torch.utils.precision import tf32_conv

# The tensor cores truncate their fp32 accumulation, and the rounding points
# that this moves grow with the sum's length: one TF32 conv over the 4608
# products of down4 moves 0.38% of its bf16 outputs off the single-rounding
# result, chunks of 64 input channels (576 products) at most 0.063%, at the
# forward's shapes on an H100 (scripts/c1_conv_modes.py).
TF32_K_CHANNELS = 64
# K slots (64 products a pixel each) between promotions of the kernel's
# wgmma accumulator into its float32 sum (csrc/conv_down.cu): chains of 576
# products, as above
PROMOTE = 9

STEM_CHANNELS = 3
STEM_K = 32             # the stem's 27 products a pixel, zero-padded
K_SLOT = 64             # channels per ring slot: one 128-byte row of bf16
# (consumer warpgroups, BN, blocks per SM) of the downs: a block computes a
# (64 * warpgroups)-pixel x BN tile of out
DOWN_TILES = ((2, 128, 1), (2, 64, 1), (1, 64, 2))
TILE_WIDTHS = (8, 16, 32, 64)   # a down tile's output columns (Wt); Ht = BM / Wt
# the planner's rates (csrc/conv_p2d.cu's bf16 ones): tensor-core MACs a
# clock an SM, bytes into an SM a clock, 16 x the clocks of one output's
# epilogue
PLAN_RATES = (2048, 64, 3)
_ROW = 128


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def _pads(pad: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    """(rows, columns) of zero padding of ``pad`` (an int or a pair)."""
    return (pad, pad) if isinstance(pad, int) else tuple(pad)


def output_hw(h: int, w: int, c: int, pad_h: int) -> Tuple[int, int]:
    """(Ho, Wo) of the stem (c = 3, stride 1) or a down (stride 2) over an
    h x w input with ``pad_h`` rows of zeros above and below (W padded by
    one)."""
    if c == STEM_CHANNELS:
        return h + 2 * pad_h - 2, w
    return (h + 2 * pad_h - 3) // 2 + 1, w // 2


# ---------------------------------------------------------------------------
# The downs' tiles (csrc/conv_down.cu: TILES, tile_width, plan)
# ---------------------------------------------------------------------------

def tile_width(bm: int, ho: int, wo: int) -> int:
    """The tile width of a ``bm``-pixel tile over ``ho`` x ``wo`` outputs:
    of :data:`TILE_WIDTHS` (at most ``bm``), the one whose tiles cover it
    with the fewest pixels, the widest on a tie."""
    best, best_area = TILE_WIDTHS[0], None
    for wt in TILE_WIDTHS:
        if wt > bm:
            break
        ht = bm // wt
        area = -(-ho // ht) * ht * -(-wo // wt) * wt
        if best_area is None or area <= best_area:
            best, best_area = wt, area
    return best


def tiles_cost(variant: int, b: int, ho: int, wo: int, c: int, n: int, sms: int) -> int:
    """The planner's cost of a down with ``DOWN_TILES[variant]``, in SM
    clocks: per slot, the larger of its tensor-core time and the time to
    bring its bytes into the SM; the persistent grid gives each SM ceil(grid
    / sms) blocks of ceil(tiles / grid) tiles; each tile's epilogue overlaps
    the other blocks (``ops/fused_conv.py::tiles_cost``'s model and rates)."""
    wgs, bn, bps = DOWN_TILES[variant]
    macs, bytes_per_clock, epi_x16 = PLAN_RATES
    bm = 64 * wgs
    wt = tile_width(bm, ho, wo)
    ht = bm // wt
    tiles = b * -(-ho // ht) * -(-wo // wt) * -(-n // bn)
    grid = min(tiles, sms * bps)
    slot = max(bm * bn * K_SLOT // macs, (bm + bn) * _ROW // bytes_per_clock)
    per_block = -(-tiles // grid)
    steps = 3 * (-(-2 * c // K_SLOT) + -(-c // K_SLOT))   # pair ox's 2C, then dx = 0's C
    return -(-grid // sms) * per_block * steps * slot + per_block * bm * bn * epi_x16 // 16


def plan_tiles(b: int, h: int, w: int, c: int, n: int, pad_h: int = 1,
               sms: int = 132) -> Tuple[int, int]:
    """(index of :data:`DOWN_TILES`, tile width) of a down of a [b, h, w, c]
    input to ``n`` channels on a card of ``sms`` SMs: the cheapest by
    :func:`tiles_cost`, the first on a tie (the C launcher's ``plan``)."""
    ho, wo = output_hw(h, w, c, pad_h)
    costs = [tiles_cost(v, b, ho, wo, c, n, sms) for v in range(len(DOWN_TILES))]
    v = costs.index(min(costs))
    return v, tile_width(64 * DOWN_TILES[v][0], ho, wo)


# ---------------------------------------------------------------------------
# Weight layouts
# ---------------------------------------------------------------------------

def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """An OIHW 3x3 weight in the kernel's K-major layout: the stem's [N, 32]
    (K = (3 dy + dx) * 3 + c, zeros from 27); a down's [N, 3, 3C], each
    kernel row's taps in the order dx = 1, 2, 0 (pixel pair ox, then the
    second pixel of pair ox - 1)."""
    n, c = weight.shape[:2]
    w = weight.permute(0, 2, 3, 1)                    # [N, dy, dx, C]
    if c == STEM_CHANNELS:
        return F.pad(w.reshape(n, 9 * c), (0, STEM_K - 9 * c)).contiguous()
    # slices, not an index list: no host-to-device copy, so a CUDA graph
    # can capture it
    return torch.cat([w[:, :, 1:], w[:, :, :1]], dim=2).reshape(n, 3, 3 * c).contiguous()


def _cached(w: torch.Tensor, b: torch.Tensor, attr: str, make):
    """``make()``, kept on ``w`` under ``attr`` until ``w`` or ``b`` moves or
    is written in place.  An inference tensor has no version counter, so
    nothing shows that it was written: its value is made anew on every call
    (as ``ops/fused_conv.py::k_major``)."""
    if w.is_inference() or (b is not None and b.is_inference()):
        return make()
    key = (w.data_ptr(), w._version) + (() if b is None else (b.data_ptr(), b._version))
    cached = getattr(w, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, make())
        setattr(w, attr, cached)
    return cached[1]


def k_major(weight: torch.Tensor, bias: torch.Tensor):
    """(:func:`kernel_weight`, the bias as float32), made once a weight and
    bias."""
    return _cached(weight, bias, "_conv_down",
                   lambda: (kernel_weight(weight), bias.float().contiguous()))


def weight_chunks(weight: torch.Tensor):
    """The plain version's float32 weight chunks of ``TF32_K_CHANNELS``
    input channels, made once a weight."""
    return _cached(weight, None, "_fp32_chunks",
                   lambda: [weight[:, c:c + TF32_K_CHANNELS].float()
                            for c in range(0, weight.shape[1], TF32_K_CHANNELS)])


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def activate_(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activation on a float conv result, in place where that saves a
    pass (Mish: ``F.mish``, within float32 rounding of ``activations.mish``)."""
    if act == "leaky":
        return F.leaky_relu(y, A.LEAKY_SLOPE)
    if act == "mish":
        return A.mish_(y)
    if act == "linear":
        return y
    raise ValueError(f"unknown activation {act!r}; expected one of {sorted(A.CODES)}")


def conv_down_ref(x, weight, bias, stride: int, pad, act: str = "leaky") -> torch.Tensor:
    """Plain version of :func:`conv_down`: the chunked TF32 convs, the bias
    and the activation in float32, one rounding to bf16."""
    y = None
    with tf32_conv():
        for c, w in zip(range(0, x.shape[1], TF32_K_CHANNELS), weight_chunks(weight)):
            part = F.conv2d(x[:, c:c + TF32_K_CHANNELS].float(), w, None, stride, pad)
            y = part if y is None else y + part
    y = y + bias.float()[:, None, None]
    return activate_(y, act).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_down")
    for name, args in (("yolo_conv_down_bf16", _ARGS),
                       ("yolo_conv_down_tiles", [ctypes.c_int] * 2 + _ARGS),
                       ("yolo_conv_down_plan", [ctypes.c_int] * 6)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _error(rc: int) -> str:
    return _lib().yolo_cuda_error_string(rc).decode()


def plan_on_device(b: int, h: int, w: int, c: int, n: int, pad_h: int = 1) -> Tuple[int, int]:
    """(index of :data:`DOWN_TILES`, tile width) that the C launcher picks
    for this down on the current CUDA device (the card's own
    :func:`plan_tiles`)."""
    v = _lib().yolo_conv_down_plan(b, h, w, c, n, pad_h)
    if v < 0:
        raise RuntimeError(f"conv_down plan failed: {_error(-v)}")
    return v // 16, 1 << (v % 16)


def _launch(x, wk, bias32, stride, pad, act, tiles=None):
    """Check the operands and run the kernel on the NHWC view of ``x``;
    ``tiles`` (index of :data:`DOWN_TILES`, tile width) overrides the
    planner's for a down."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv_down: the kernel takes bfloat16 input, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"conv_down: x must be NCHW, got {tuple(x.shape)}")
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)                                 # NHWC view
    if not y.is_contiguous():
        raise ValueError("conv_down: x must be channels_last (NHWC) contiguous")
    pad_h, pad_w = _pads(pad)
    if pad_h not in (0, 1) or pad_w != 1:
        raise ValueError(f"conv_down: pad must be 1 or (0 | 1, 1), got {pad}")
    if act not in A.CODES:
        raise ValueError(f"conv_down: act {act!r} (one of {sorted(A.CODES)})")
    if c == STEM_CHANNELS:
        if stride != 1 or w % 2:
            raise ValueError(f"conv_down: the stem (3 input channels) takes stride 1 and even "
                             f"W (4-byte words of [B, H, 3W]); got stride {stride}, W = {w}")
    elif stride != 2 or c % 8 or w % 2:
        raise ValueError(f"conv_down: a down takes stride 2, C % 8 == 0 and even W; got "
                         f"stride {stride}, C = {c}, W = {w}")
    n = bias32.shape[0]
    if wk.dtype != torch.bfloat16 or bias32.dtype != torch.float32 or n % 8:
        raise ValueError("conv_down: bf16 weight, float32 bias and N % 8 == 0")
    want = (n, STEM_K) if c == STEM_CHANNELS else (n, 3, 3 * c)
    if tuple(wk.shape) != want or not wk.is_contiguous():
        raise ValueError(f"conv_down: weight layout must be {want}, got {tuple(wk.shape)}")
    if any(t.device != x.device for t in (wk, bias32)):
        raise ValueError("conv_down: all operands must be on one device")
    if y.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv_down: x and the weight must start on a 16-byte boundary")
    ho, wo = output_hw(h, w, c, pad_h)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_down: no output for an input of {h} x {w}")
    out = torch.empty((b, ho, wo, n), dtype=torch.bfloat16, device=x.device)
    args = (y.data_ptr(), wk.data_ptr(), bias32.data_ptr(), out.data_ptr(), b, h, w, c, n,
            pad_h, A.CODES[act], torch.cuda.current_stream(x.device).cuda_stream)
    if tiles is None:
        fn = _lib().yolo_conv_down_bf16
    else:
        variant, wt = tiles
        fn, args = _lib().yolo_conv_down_tiles, (variant, wt.bit_length() - 1) + args
    with torch.cuda.device(x.device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"conv_down kernel launch failed for x {tuple(x.shape)}, N={n}: "
                           f"{_error(rc)}")
    return out.permute(0, 3, 1, 2)                            # NCHW, channels_last


def conv_down(x, weight, bias, stride: int, pad, act: str = "leaky") -> torch.Tensor:
    """The stem or a stride-2 down (module docstring): ``x`` NCHW
    (``channels_last``) bf16, ``weight`` OIHW bf16 3x3, ``bias`` [N];
    returns NCHW (``channels_last``) bf16.  A CUDA ``x`` runs the kernel or
    raises; a CPU one runs :func:`conv_down_ref`.  ``conv_down.launches``
    counts kernel launches."""
    if x.device.type == "cpu":
        return conv_down_ref(x, weight, bias, stride, pad, act)
    if x.device.type != "cuda":
        raise ValueError(f"conv_down: unsupported device {x.device}")
    if tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"conv_down: weight {tuple(weight.shape)} is not 3x3 over "
                         f"{x.shape[1]} channels")
    wk, bias32 = k_major(weight, bias)
    out = _launch(x, wk, bias32, stride, pad, act)
    conv_down.launches += 1
    return out


conv_down.launches = 0
