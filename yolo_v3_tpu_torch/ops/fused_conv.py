"""Fused int8 and bf16 convolutions on the padded-2D activation layout: the
port of ``yolo_v3_tpu/ops/fused_conv.py`` (``conv1x1_p2d``, ``conv3x3_p2d``,
``res_block_p2d``).

A [B, H, W, C] tensor is stored as ``x2d`` [B*(H+2)*(W+2), C]: each image
zero-padded by one pixel on every side, (batch, row, col) flattened.  The 9
taps of a 3x3/stride-1 SAME conv are then constant row offsets::

    out[g] = sum_{dy,dx} x2d[g + (dy-1)*(W+2) + (dx-1)] @ w[dy, dx]

and the epilogue re-zeroes the border rows, so the layout is closed under
composition: a whole stage of residual blocks, or a head, runs in it.
Rows outside [0, R) read as 0.

The input is int8 (int32 accumulation, exact) or bf16 (float32
accumulation), with a weight of the same dtype and a residual of the
input's dtype.  Epilogue, in this order (float32, each step rounded, no
fused multiply-add)::

    y = acc * scale + bias;  y = act(y);  y = y + residual * res_scale
    y = 0 on border rows;    int8: clip(round_half_even(y), -127, 127)
                             bf16: round to nearest even

``act`` is none, leaky (``leaky=True``, the default) or, for bf16 input,
Mish (``act="mish"``: YOLOv4's CSP 1x1s; ``ops/activations.py``); ``act``
names it and overrides ``leaky`` when given.

:func:`conv1x1_p2d` and :func:`conv3x3_p2d` launch the CUDA kernel
(``csrc/conv_p2d.cu``: ``wgmma`` fed by TMA, one kernel in two input
types) for a CUDA tensor and use their plain versions (``*_ref``) for a
CPU tensor.  The int8 mode serves the int8 model (``models/quantized.py``);
int8 channels that do not make 16-byte rows (C % 16 != 0, no model shape)
are zero-padded to the next multiple of 16 for TMA, which leaves the int32
sum unchanged.  The bf16 mode serves the float model's heads
(``models/darknet.py``) with ``scale`` = 1, so that conv, bias and leaky
round once, as the reference's ``_conv_bias_leaky`` does.  The tile shape
is picked per shape and input type by :func:`plan_tiles`, which the C
launcher mirrors.

:func:`conv_i8_nhwc` is the plain NHWC int8 convolution (:func:`conv_i8_acc`:
explicit im2col + an exact int32 product) with the same epilogue: the plain
version of the entry chain and the int8 path's stride-2 downsamples (and,
in a tree without space-to-depth, its stem).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import _build
from yolo_v3_tpu_torch.ops import activations as A
from yolo_v3_tpu_torch.utils.precision import full_fp32

LEAKY = 0.1

_OUT_DTYPES = (torch.int8, torch.bfloat16)
# input dtype -> the suffix of the kernel's C entry points
_IN_DTYPES = {torch.int8: "i8", torch.bfloat16: "bf16"}


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def pack_p2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B*(H+2)*(W+2), C] with one zero-pixel border."""
    b, h, w, c = x.shape
    return F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b * (h + 2) * (w + 2), c)


def unpack_p2d(x2d: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """[B*(H+2)*(W+2), C] -> [B, H, W, C] (borders dropped; a view)."""
    return x2d.reshape(b, h + 2, w + 2, x2d.shape[-1])[:, 1:h + 1, 1:w + 1, :]


def p2d_geometry(b: int, h: int, w: int) -> Tuple[int, int, int]:
    """(R, hp, wp) of the padded-2D layout for a [b, h, w, *] tensor."""
    return b * (h + 2) * (w + 2), h + 2, w + 2


def set_border_rows(x2d: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor,
                    hp: int, wp: int) -> torch.Tensor:
    """Write ``top`` and ``bottom`` ([B, 1, W, C]) into the top and bottom
    border rows of every image of ``x2d``, in place, and return it; the
    left and right border pixels keep their zeros.  A height-sharded
    forward puts a neighbouring stripe's rows there, where a 3x3 conv's
    taps read them; a 1x1 reads no border row, and the epilogue writes the
    border rows of its output as zeros."""
    v = x2d.view(-1, hp, wp, x2d.shape[-1])
    v[:, :1, 1:wp - 1] = top
    v[:, hp - 1:, 1:wp - 1] = bottom
    return x2d


def border_mask(r: int, hp: int, wp: int, device) -> torch.Tensor:
    """[R] bool: True for the non-border rows of the padded-2D layout."""
    p = torch.arange(r, device=device) % (hp * wp)
    row, col = p // wp, p % wp
    return (row >= 1) & (row <= hp - 2) & (col >= 1) & (col <= wp - 2)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 [M, K] @ [K, N] through ``torch._int_mm``.
    On CUDA cuBLASLt takes only some shapes (M > 16 and K, N multiples of 8
    are documented; it also refused M = 1096 at K = 112): the operands are
    zero-padded to multiples of 32 and the result cut back."""
    m, n = a.shape[0], b.shape[1]
    if a.is_cuda:
        k32 = -(-a.shape[1] // 32) * 32
        a = _pad_to(_pad_to(a, 1, k32), 0, -(-m // 32) * 32)
        b = _pad_to(_pad_to(b, 0, k32), 1, -(-n // 32) * 32)
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def _act_name(leaky: bool, act) -> str:
    return act if act is not None else ("leaky" if leaky else "linear")


def epilogue_ref(acc, scale, bias, *, leaky=True, residual=None, res_scale=1.0,
                 valid=None, out_dtype=torch.int8, act=None):
    """The kernels' epilogue on an int32 accumulator [..., N]: float32
    multiply, add, the activation (``act``, else leaky or none by
    ``leaky``), residual multiply-add, mask, then requantize to int8 (round
    half to even, clip to +-127) or round to bf16 (or float32).  ``valid``
    broadcasts against ``acc``; masked values become 0."""
    y = acc.float() * scale.float()
    y = y + bias.float()
    y = A.apply(y, _act_name(leaky, act))
    if residual is not None:
        y = y + residual.float() * res_scale
    if valid is not None:
        y = torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=y.device))
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def _w2d(w: torch.Tensor, c: int, taps: int) -> torch.Tensor:
    """A 1x1 ([C, N] or [1, 1, C, N]) or 3x3 ([3, 3, C, N], [9, C, N] or
    [9C, N]) weight as [taps*C, N]."""
    if w.numel() % (taps * c) != 0:
        raise ValueError(f"weight {tuple(w.shape)} does not have {taps} taps of "
                         f"{c} input channels")
    w2 = w.reshape(taps * c, -1)
    if tuple(w.shape[-1:]) != tuple(w2.shape[-1:]):
        raise ValueError(f"weight {tuple(w.shape)} does not have {taps} taps of "
                         f"{c} input channels")
    return w2


def _tap_rows(x2d: torch.Tensor, wp: int) -> torch.Tensor:
    """[R, C] -> [R, 9C]: the 9 tap rows of each output row, zeros outside
    [0, R) (im2col in the padded-2D layout)."""
    r = x2d.shape[0]
    halo = wp + 1
    xh = F.pad(x2d, (0, 0, halo, halo))
    return torch.cat([xh[dy * wp + dx:dy * wp + dx + r]
                      for dy in range(3) for dx in range(3)], dim=1)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' accumulator of [M, K] @ [K, N]: exact int32 for int8;
    float32 for bf16, whose values are exact in float32 (TF32 off)."""
    if a.dtype == torch.int8:
        return int_mm(a, b)
    with full_fp32():
        return a.float() @ b.float()


def conv1x1_p2d_ref(x2d, w, scale, bias, hp, wp, *, leaky=True,
                    out_dtype=torch.int8, residual=None, res_scale=1.0, act=None):
    """Plain version of :func:`conv1x1_p2d` (also in float32)."""
    acc = _product(x2d, _w2d(w, x2d.shape[1], 1))
    valid = border_mask(x2d.shape[0], hp, wp, x2d.device)[:, None]
    return epilogue_ref(acc, scale, bias, leaky=leaky, residual=residual,
                        res_scale=res_scale, valid=valid, out_dtype=out_dtype, act=act)


def conv3x3_p2d_ref(x2d, w, scale, bias, hp, wp, *, leaky=True,
                    out_dtype=torch.int8, residual=None, res_scale=1.0, act=None):
    """Plain version of :func:`conv3x3_p2d` (also in float32)."""
    acc = _product(_tap_rows(x2d, wp), _w2d(w, x2d.shape[1], 9))
    valid = border_mask(x2d.shape[0], hp, wp, x2d.device)[:, None]
    return epilogue_ref(acc, scale, bias, leaky=leaky, residual=residual,
                        res_scale=res_scale, valid=valid, out_dtype=out_dtype, act=act)


def res_block_p2d_ref(x2d, w1, s1, b1, w2, s2, b2, hp, wp, *,
                      out_dtype=torch.int8, res_scale=1.0, border=None):
    """Plain version of :func:`res_block_p2d`."""
    mid = conv1x1_p2d_ref(x2d, w1, s1, b1, hp, wp, out_dtype=x2d.dtype)
    if border is not None:
        mid = border(mid)
    return conv3x3_p2d_ref(mid, w2, s2, b2, hp, wp, out_dtype=out_dtype,
                           residual=x2d, res_scale=res_scale)


def conv_i8_acc(x, w, *, stride=1,
                padding: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
    """The exact int32 accumulator [B, Ho, Wo, N] of an int8 NHWC convolution
    with an HWIO int8 weight: an explicit im2col and :func:`int_mm`.
    ``padding`` is ((top, bottom), (left, right)); the default is SAME for
    odd kernels."""
    kh, kw, c, n = w.shape
    if padding is None:
        padding = (((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2)
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    b, hh, ww, _ = xp.shape
    ho, wo = (hh - kh) // stride + 1, (ww - kw) // stride + 1
    cols = torch.cat([
        xp[:, dy:dy + stride * (ho - 1) + 1:stride,
           dx:dx + stride * (wo - 1) + 1:stride, :]
        for dy in range(kh) for dx in range(kw)], dim=-1)
    acc = int_mm(cols.reshape(b * ho * wo, kh * kw * c), w.reshape(kh * kw * c, n))
    return acc.reshape(b, ho, wo, n)


def conv_i8_nhwc(x, w, scale, bias, *, stride=1,
                 padding: Optional[Sequence[Tuple[int, int]]] = None,
                 residual=None, res_scale=1.0):
    """int8 NHWC convolution with an HWIO int8 weight, int32 accumulation and
    the kernels' leaky int8 epilogue (the JAX ``quantized._conv_i8``);
    ``padding`` as :func:`conv_i8_acc`'s."""
    acc = conv_i8_acc(x, w, stride=stride, padding=padding)
    b, ho, wo, n = acc.shape
    out = epilogue_ref(acc.reshape(-1, n), scale, bias,
                       residual=None if residual is None else residual.reshape(-1, n),
                       res_scale=res_scale)
    return out.reshape(b, ho, wo, n)


# ---------------------------------------------------------------------------
# The kernel's tiles (csrc/conv_p2d.cu: TILES, plan)
# ---------------------------------------------------------------------------

# (consumer warpgroups, BN, blocks per SM): a block computes a
# (64 * warpgroups) x BN tile of out
P2D_TILES = ((2, 128, 1), (1, 64, 2))
_ROW = 128              # bytes per row of a staged operand (the 128-byte swizzle)
# channels per ring slot: one 128-byte row of an operand
K_SLOT = {torch.bfloat16: 64, torch.int8: 128}
# the planner's rates per input type (csrc/conv_p2d.cu: Bf16In, I8In):
# tensor-core MACs a clock an SM, bytes into an SM a clock, 16 x the clocks
# of one output's epilogue
PLAN_RATES = {torch.bfloat16: (2048, 64, 3), torch.int8: (4096, 64, 3)}
_EPI_LD = 144           # bytes per staged epilogue row (128 + 16)
SMEM_PER_SM = 233472    # the H100's shared memory per SM (228 KB)
SMEM_PER_BLOCK = 232448  # ... of which one block may use (227 KB)


def taps_per_slot(taps: int) -> int:
    """The 3x3 stages the three taps of one kernel row per ring slot (one A
    box of BM + 2 rows serves all three); the 1x1 its one tap."""
    return 3 if taps == 9 else 1


def _slot_bytes(variant: int, taps: int) -> int:
    """Bytes of one ring slot: the same in both input types."""
    wgs, bn, _ = P2D_TILES[variant]
    a_rows = 64 * wgs + (8 if taps == 9 else 0)
    return (a_rows + taps_per_slot(taps) * bn) * _ROW


def _fixed_smem(variant: int) -> int:
    """1024 bytes of alignment slack, each consumer warp's 16-row epilogue
    staging and the ring's barriers (at most 8 slots)."""
    return 1024 + 4 * P2D_TILES[variant][0] * 16 * _EPI_LD + 128


def ring_slots(variant: int, taps: int) -> int:
    """Ring slots of the kernel: as many as the shared memory of one of
    ``bps`` blocks of an SM holds beside the fixed part, at most 8."""
    bps = P2D_TILES[variant][2]
    budget = SMEM_PER_BLOCK if bps == 1 else SMEM_PER_SM // bps - 1024
    return min(8, (budget - _fixed_smem(variant)) // _slot_bytes(variant, taps))


def smem_bytes(variant: int, taps: int) -> int:
    """Dynamic shared memory of one block of the kernel."""
    return _fixed_smem(variant) + ring_slots(variant, taps) * _slot_bytes(variant, taps)


def tiles_cost(variant: int, r: int, c: int, n: int, taps: int, sms: int,
               dtype: torch.dtype) -> int:
    """The planner's cost of one launch with ``P2D_TILES[variant]`` for
    input of ``dtype``, in SM clocks: per ring slot, the larger of the
    tensor-core time (BM * BN * K_SLOT * taps-per-slot MACs at the input
    type's rate) and the time to bring its bytes into the SM; the persistent
    grid gives each SM ceil(grid / sms) blocks of ceil(tiles / grid) tiles,
    which share its tensor cores; each tile's epilogue overlaps the other
    blocks.  The rates (:data:`PLAN_RATES`) are fitted to the tile shapes'
    times on an H100 (PERF.md)."""
    wgs, bn, bps = P2D_TILES[variant]
    macs, bytes_per_clock, epi_x16 = PLAN_RATES[dtype]
    bm, tps, kslot = 64 * wgs, taps_per_slot(taps), K_SLOT[dtype]
    tiles = -(-r // bm) * -(-n // bn)
    steps = taps // tps * -(-c // kslot)
    grid = min(tiles, sms * bps)
    slot = max(bm * bn * kslot * tps // macs, _slot_bytes(variant, taps) // bytes_per_clock)
    per_block = -(-tiles // grid)
    return -(-grid // sms) * per_block * steps * slot + per_block * bm * bn * epi_x16 // 16


def plan_tiles(r: int, c: int, n: int, taps: int, dtype: torch.dtype,
               sms: int = 132) -> int:
    """The index of :data:`P2D_TILES` that the kernel runs [R, C] @ [taps*C,
    N] with, for input of ``dtype`` on a card of ``sms`` SMs: the cheapest
    by :func:`tiles_cost`, the first on a tie (the C launcher's ``plan``)."""
    costs = [tiles_cost(v, r, c, n, taps, sms, dtype) for v in range(len(P2D_TILES))]
    return costs.index(min(costs))


def pad_channels(x2d: torch.Tensor, wt: torch.Tensor, taps: int):
    """``x2d`` [R, C] and the K-major weight ``wt`` [N, taps*C] as the
    kernel reads them: int8 channels zero-padded to the next multiple of 16
    where C is not one (TMA loads rows of 16 bytes; the zeros add nothing to
    the int32 sum); bf16 as they are (the wrapper rejects C % 8 != 0)."""
    c = x2d.shape[1]
    if x2d.dtype != torch.int8 or c % 16 == 0:
        return x2d, wt
    cp, n = -(-c // 16) * 16, wt.shape[0]
    return (F.pad(x2d, (0, cp - c)),
            F.pad(wt.view(n, taps, c), (0, cp - c)).view(n, taps * cp))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LAUNCH_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p]
                + [ctypes.c_int] * 7 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_p2d")
    signatures = {f"yolo_conv{k}_p2d_{t}": _LAUNCH_ARGS for k in ("1x1", "3x3")
                  for t in ("i8", "bf16")}
    # the forced-tiles entry takes (is_i8, taps, variant) first
    signatures["yolo_conv_p2d_tiles"] = [ctypes.c_int] * 3 + _LAUNCH_ARGS
    signatures["yolo_conv_p2d_plan"] = [ctypes.c_int] * 5
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _error(rc: int) -> str:
    return _lib().yolo_cuda_error_string(rc).decode()


def plan_on_device(r: int, c: int, n: int, taps: int, dtype: torch.dtype) -> int:
    """The index of :data:`P2D_TILES` that the C launcher picks for this
    shape and input type on the current CUDA device (the card's own
    :func:`plan_tiles`)."""
    v = _lib().yolo_conv_p2d_plan(int(dtype == torch.int8), r, c, n, taps)
    if v < 0:
        raise RuntimeError(f"p2d plan failed: {_error(-v)}")
    return v


def k_major(w: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``w2`` [K, N] (a view of the caller's weight ``w``) as a contiguous
    [N, K]: the layout the kernel reads.  The copy is cached on ``w`` until
    ``w`` moves or is written in place, so a model's weights are transposed
    once.  An inference tensor has no version counter, so nothing shows that
    it was written: its copy is made anew on every call."""
    if w.is_inference():
        return w2.t().contiguous()
    key = (w.data_ptr(), w._version)
    cached = getattr(w, "_k_major", None)
    if cached is None or cached[0] != key:
        cached = (key, w2.t().contiguous())
        w._k_major = cached
    return cached[1]


def _launch(name, taps, x2d, w, scale, bias, hp, wp, leaky, out_dtype,
            residual, res_scale, tiles=None, act=None):
    """Check the operands of a CUDA launch and run the kernel; ``tiles``
    (an index of :data:`P2D_TILES`) overrides the planner's tile shape.
    int8 channels that do not make 16-byte rows are zero-padded to a
    multiple of 16 (x2d and the K-major weight; an exact int32 sum)."""
    if x2d.dtype not in _IN_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes int8 or bfloat16 input, got "
                        f"{x2d.dtype}")
    if x2d.dim() != 2:
        raise ValueError(f"{name}: x2d must be [R, C], got {tuple(x2d.shape)}")
    r, c = x2d.shape
    w2 = _w2d(w, c, taps)
    n = w2.shape[1]
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be int8 or bfloat16, got {out_dtype}")
    if w.dtype != x2d.dtype:
        raise TypeError(f"{name}: w must be {x2d.dtype} like x2d, got {w.dtype}")
    if x2d.dtype == torch.bfloat16 and c % 8:
        raise ValueError(f"{name}: the bf16 kernel loads x2d by TMA in 16-byte rows: "
                         f"C must be a multiple of 8, got {c}")
    if tiles is not None and not 0 <= tiles < len(P2D_TILES):
        raise ValueError(f"{name}: tiles={tiles} is not an index of P2D_TILES")
    act = _act_name(leaky, act)
    if act not in A.CODES or (act == "mish" and x2d.dtype != torch.bfloat16):
        raise ValueError(f"{name}: act {act!r} (linear, leaky; mish for bfloat16 input)")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name}: scale and bias must be float32")
    if tuple(scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"{name}: scale and bias must be [{n}], got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    operands = [x2d, w2, scale, bias]
    if residual is not None:
        if residual.dtype != x2d.dtype:
            raise TypeError(f"{name}: the kernel's residual must be {x2d.dtype} like "
                            f"x2d, got {residual.dtype}")
        if tuple(residual.shape) != (r, n):
            raise ValueError(f"{name}: residual must be [{r}, {n}], got "
                             f"{tuple(residual.shape)}")
        operands.append(residual)
    if any(t.device != x2d.device for t in operands):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    if x2d.data_ptr() % 16:
        raise ValueError(f"{name}: x2d must start on a 16-byte boundary")
    if hp < 3 or wp < 3 or r <= 0 or n <= 0:
        raise ValueError(f"{name}: bad geometry R={r} hp={hp} wp={wp} N={n}")
    x2d, wt = pad_channels(x2d, k_major(w, w2), taps)
    out = torch.empty((r, n), dtype=out_dtype, device=x2d.device)
    args = (x2d.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            0 if residual is None else residual.data_ptr(), float(res_scale),
            out.data_ptr(), int(out_dtype == torch.bfloat16), r, x2d.shape[1], n, hp, wp,
            A.CODES[act], torch.cuda.current_stream(x2d.device).cuda_stream)
    if tiles is None:
        fn = getattr(_lib(), f"yolo_{name}_{_IN_DTYPES[x2d.dtype]}")
    else:
        fn, args = _lib().yolo_conv_p2d_tiles, (int(x2d.dtype == torch.int8), taps, tiles) + args
    with torch.cuda.device(x2d.device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed for x2d {tuple(x2d.shape)}, "
                           f"N={n}: {_error(rc)}")
    return out


def _on_cuda(name, x2d):
    if x2d.device.type == "cpu":
        return False
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2d.device}")
    return True


def conv1x1_p2d(x2d, w, scale, bias, hp, wp, *, leaky=True,
                out_dtype=torch.int8, residual=None, res_scale=1.0, act=None):
    """Pointwise conv on the padded-2D layout: ``x2d`` [R, C] int8 or bf16,
    ``w`` [C, N] of the same dtype, ``scale``/``bias`` [N] float32,
    ``residual`` [R, N] of the input's dtype or None; returns [R, N] int8 or
    bf16 with zero borders.  A CUDA ``x2d`` runs the kernel or raises; a CPU one
    runs :func:`conv1x1_p2d_ref`.  ``conv1x1_p2d.launches`` counts kernel
    launches."""
    if not _on_cuda("conv1x1_p2d", x2d):
        return conv1x1_p2d_ref(x2d, w, scale, bias, hp, wp, leaky=leaky,
                               out_dtype=out_dtype, residual=residual,
                               res_scale=res_scale, act=act)
    out = _launch("conv1x1_p2d", 1, x2d, w, scale, bias, hp, wp, leaky,
                  out_dtype, residual, res_scale, act=act)
    conv1x1_p2d.launches += 1
    return out


def conv3x3_p2d(x2d, w, scale, bias, hp, wp, *, leaky=True,
                out_dtype=torch.int8, residual=None, res_scale=1.0, act=None):
    """3x3 stride-1 SAME conv on the padded-2D layout: ``w`` [3, 3, C, N]
    (or [9, C, N], [9C, N]); otherwise as :func:`conv1x1_p2d`.
    ``conv3x3_p2d.launches`` counts kernel launches."""
    if not _on_cuda("conv3x3_p2d", x2d):
        return conv3x3_p2d_ref(x2d, w, scale, bias, hp, wp, leaky=leaky,
                               out_dtype=out_dtype, residual=residual,
                               res_scale=res_scale, act=act)
    out = _launch("conv3x3_p2d", 9, x2d, w, scale, bias, hp, wp, leaky,
                  out_dtype, residual, res_scale, act=act)
    conv3x3_p2d.launches += 1
    return out


conv1x1_p2d.launches = 0
conv3x3_p2d.launches = 0


def res_block_p2d(x2d, w1, s1, b1, w2, s2, b2, hp, wp, *,
                  out_dtype=torch.int8, res_scale=1.0, border=None):
    """x + leaky(conv3x3(leaky(conv1x1(x)))) with the add fused into the
    3x3's epilogue; ``res_scale`` rescales the identity into the output's
    quantization domain (1 for bf16).  The composition of the two kernels (their plain
    versions on a CPU tensor).  ``border`` (a callable, or None) takes the
    1x1's output and returns it with its border rows filled before the 3x3
    reads it: a height-sharded forward puts the neighbouring stripes' rows
    of the 1x1's output there (:func:`set_border_rows`).
    ``res_block_p2d.launches`` counts the blocks run on the card, each one
    launch of either kernel."""
    mid = conv1x1_p2d(x2d, w1, s1, b1, hp, wp, out_dtype=x2d.dtype)
    if border is not None:
        mid = border(mid)
    out = conv3x3_p2d(mid, w2, s2, b2, hp, wp, out_dtype=out_dtype,
                      residual=x2d, res_scale=res_scale)
    if x2d.device.type == "cuda":
        res_block_p2d.launches += 1
    return out


res_block_p2d.launches = 0
