"""int8 serving: calibration, quantization, the serving artifact and the
quantized forward, and the per-layer int8 helpers.  Port of
``yolo_v3_tpu/models/quantized.py``: trees with and without the
space-to-depth entry, the float-image feed and (on s2d trees) the uint8
feed.

Scheme (the JAX package's, unchanged):

* weights: per-output-channel symmetric int8 (absmax / 127);
* activations: per-tensor static scales from a calibration pass (the
  0.9997 quantile of |x| of every conv's output, post-residual-add for the
  residual blocks);
* every interior conv takes and gives int8; its epilogue is
  ``clip(round(leaky(acc * m + b)))`` with ``m = s_in * s_w / s_out`` and
  ``b = bias / s_out``; residual adds are ``+ q_res * s_res / s_out`` before
  rounding; route concats requantize both branches to a common scale; the
  detection convs keep float epilogues and bf16 outputs.

The quantization math is numpy, as in the JAX package, so the same folded
weights and statistics give a bit-equal tree.  Trees are nested dicts:
int8/float32 tensors, Python floats (``res_scale``, ``scales/*``) and a
tuple of floats (``route_scales``).

:class:`YoloNetQuantized` runs the forward on the hand-written kernels: an
s2d tree's entry (stem .. stage 1's downsample) on ``fused_entry``, every
residual block and head conv on ``conv1x1_p2d`` / ``conv3x3_p2d`` in the
padded-2D layout.  The stride-2 downsamples outside the entry (stages 2-4;
in a tree without s2d also the stem and stages 0-1's) are plain int8 GEMMs
(``conv_i8_nhwc``).

Under a ``(data, space)`` mesh with ``space`` > 1 the forward takes this
rank's stripe of the images' rows (whole 32-row bands) and returns the
whole heads on every rank of its space group, bit-equal to one process's:
the entry runs on the stripe's window (:func:`entry_window`: 13 image rows
of the stripe above, 7 of the stripe below) and cuts the rows that its
internal padding makes wrong (:data:`ENTRY_CUT`); every other 3x3 reads a
row of each neighbouring stripe, the NHWC convs as halo rows, the p2d
convs in the layout's border rows (between the block's two launches for a
residual block); the heads are gathered at the end
(``parallel/halo.py``).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.ops import entry_kernel as EK
from yolo_v3_tpu_torch.ops import fused_conv as FC
from yolo_v3_tpu_torch.parallel.halo import edge_rows, gather_rows
from yolo_v3_tpu_torch.utils.precision import full_fp32

QUANTIZED_FORMAT = "yolo_v3_tpu/quantized-v1"
# calibration quantile: 99.97% of the activation mass inside the int8 range
CALIB_Q = 0.9997


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _amax(x: torch.Tensor) -> torch.Tensor:
    """CALIB_Q quantile of |x| in x's logical (row-major) order, on a strided
    subsample of at most ~4M elements (the JAX ``_amax``)."""
    a = x.float().abs().reshape(-1)
    stride = max(a.shape[0] // (2 << 20), 1)
    if stride > 1:
        a = a[::stride]
    return torch.quantile(a, CALIB_Q)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_bias_leaky(p, x, stride=1, leaky=True):
    """fp32 SAME conv + bias (+ leaky) on an NCHW (channels_last) tensor
    from an HWIO weight."""
    w = p["w"].float().permute(3, 2, 0, 1)
    y = F.conv2d(x, w, p["b"].float(), stride, (w.shape[2] - 1) // 2)
    return F.leaky_relu(y, D.LEAKY_SLOPE) if leaky else y


def calibrate_yolonet(folded: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Run the folded float network on a calibration batch ``x`` [B, H, W, 3]
    in float32, recording the CALIB_Q quantile of every conv output (and of
    the image), keyed as the JAX ``calibrate_yolonet`` keys them.

    With ``"s2d"`` in ``folded`` the entry runs as the native convs it
    re-expresses; its statistics are taken on the space-to-depth layout of
    each native tensor (what the JAX s2d calibration sees: ``_amax``'s
    subsample depends on the layout), ``s2d/down1`` on the native one."""
    stats: Dict[str, torch.Tensor] = {"image": _amax(x)}
    p = folded["backbone"]
    use_s2d = "s2d" in folded

    def cb(pp, path, y, stride=1):
        y = _conv_bias_leaky(pp, y, stride=stride)
        stats[path] = _amax(_nhwc(y))
        return y

    def s2d_amax(y):
        return _amax(D._space_to_depth2(_nhwc(y)))

    y = _nchw(x.float()).contiguous(memory_format=torch.channels_last)
    if use_s2d:
        stats["s2d/input"] = stats["image"]
        s0 = p["stage0"]
        y = _conv_bias_leaky(p["stem"], y)
        stats["s2d/stem"] = s2d_amax(y)
        y = _conv_bias_leaky(s0["down"], y, stride=2)
        stats["s2d/down0"] = s2d_amax(y)
        r = _conv_bias_leaky(s0["res0"]["conv1"], y)
        stats["s2d/res0_1"] = s2d_amax(r)
        y = y + _conv_bias_leaky(s0["res0"]["conv2"], r)
        stats["s2d/res0_2"] = s2d_amax(y)
        y = _conv_bias_leaky(p["stage1"]["down"], y, stride=2)
        stats["s2d/down1"] = _amax(_nhwc(y))
        start_stage = 1
    else:
        y = cb(p["stem"], "backbone/stem", y)
        start_stage = 0

    routes = []
    for i in range(start_stage, D._num_stages(p)):
        sp = p[f"stage{i}"]
        if not (use_s2d and i == 1):
            y = cb(sp["down"], f"backbone/stage{i}/down", y, stride=2)
        for b in range(D._stage_blocks(sp)):
            r = cb(sp[f"res{b}"]["conv1"], f"backbone/stage{i}/res{b}/conv1", y)
            y = y + _conv_bias_leaky(sp[f"res{b}"]["conv2"], r)
            stats[f"backbone/stage{i}/res{b}/conv2"] = _amax(_nhwc(y))
        if i >= 2:
            routes.append(y)
    c3, c4, c5 = routes

    def head(hname, y):
        hp = folded[hname]
        for i in range(6):
            y = cb(hp[f"conv{i}"], f"{hname}/conv{i}", y)
            if i == 4:
                branch = y
        return branch

    def up(x):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    br0 = head("head0", c5)
    y = torch.cat([up(cb(folded["up0"]["conv"], "up0/conv", br0)), c4], dim=1)
    stats["concat1"] = _amax(_nhwc(y))
    br1 = head("head1", y)
    y = torch.cat([up(cb(folded["up1"]["conv"], "up1/conv", br1)), c3], dim=1)
    stats["concat2"] = _amax(_nhwc(y))
    head("head2", y)
    return stats


# ---------------------------------------------------------------------------
# Quantization (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _scale_of(stats, key) -> float:
    return float(max(np.asarray(stats[key], np.float32) / 127.0, 1e-8))


def _quant_w(w) -> Tuple[torch.Tensor, np.ndarray]:
    w = D._np32(w)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    s = np.maximum(absmax / 127.0, 1e-12)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return torch.from_numpy(q), s.astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _qconv(p, s_in: float, s_out) -> Dict:
    """Folded float conv {w, b} -> {w int8, m f32[N], b f32[N]};
    ``s_out=None`` keeps a float output: m = s_in*s_w, b = bias."""
    wq, sw = _quant_w(p["w"])
    b = D._np32(p["b"])
    if s_out is None:
        return {"w": wq, "m": _t(s_in * sw), "b": _t(b)}
    return {"w": wq, "m": _t(s_in * sw / s_out), "b": _t(b / s_out)}


def quantize_yolonet(folded: Dict, stats: Dict) -> Dict:
    """The int8 serving tree from BN-folded float params and calibration
    statistics (the JAX ``quantize_yolonet``, leaf for leaf)."""
    q: Dict = {"scales": {}}
    sc = q["scales"]
    p = folded["backbone"]
    use_s2d = "s2d" in folded
    for k in stats:
        sc[k] = _scale_of(stats, k)
    sc["image"] = _scale_of(stats, "image")

    qb: Dict = {}
    if use_s2d:
        sp = folded["s2d"]
        qs: Dict = {"stem": _qconv(sp["stem"], sc["image"], sc["s2d/stem"])}
        # the 4x4-domain stem and its uint8-input variant.  uint8 images go
        # in as (u8 - 128) codes of scale 1/255, the -128 pad being a real
        # 0, and the +128 zero point is folded through the conv into the
        # bias: acc_x = (acc_q + 128 * sum(w_q)) / 255 per output channel
        w4, b4 = D._stem4_weights(p["stem"]["w"], p["stem"]["b"])
        w4q, s4w = _quant_w(w4)
        s_out = sc["s2d/stem"]
        qs["stem4"] = {"w": w4q, "m": _t(sc["image"] * s4w / s_out),
                       "b": _t(b4 / s_out)}
        m_u8 = (1.0 / 255.0) * s4w / s_out
        zp = 128.0 * m_u8 * w4q.numpy().astype(np.int32).sum((0, 1, 2))
        qs["stem4_u8"] = {"w": w4q, "m": _t(m_u8), "b": _t(b4 / s_out + zp)}
        qs["down0"] = _qconv(sp["down0"], sc["s2d/stem"], sc["s2d/down0"])
        w0q, s0w = _quant_w(D._down0_4_weights(p["stage0"]["down"]["w"]))
        qs["down0_4"] = {
            "w": w0q,
            "m": _t(sc["s2d/stem"] * s0w / sc["s2d/down0"]),
            "b": _t(np.tile(D._np32(p["stage0"]["down"]["b"]), 4) / sc["s2d/down0"]),
        }
        qs["res0_1"] = _qconv(sp["res0_1"], sc["s2d/down0"], sc["s2d/res0_1"])
        qs["res0_2"] = _qconv(sp["res0_2"], sc["s2d/res0_1"], sc["s2d/res0_2"])
        qs["down1"] = _qconv(sp["down1"], sc["s2d/res0_2"], sc["s2d/down1"])
        q["s2d"] = qs
        prev = "s2d/down1"
        start_stage = 1
    else:
        qb["stem"] = _qconv(p["stem"], sc["image"], sc["backbone/stem"])
        prev = "backbone/stem"
        start_stage = 0

    route_keys = []
    for i in range(start_stage, D._num_stages(p)):
        spp = p[f"stage{i}"]
        qst: Dict = {}
        if not (use_s2d and i == 1):
            key = f"backbone/stage{i}/down"
            qst["down"] = _qconv(spp["down"], sc[prev], sc[key])
            prev = key
        for b in range(D._stage_blocks(spp)):
            k1 = f"backbone/stage{i}/res{b}/conv1"
            k2 = f"backbone/stage{i}/res{b}/conv2"
            qst[f"res{b}"] = {
                "conv1": _qconv(spp[f"res{b}"]["conv1"], sc[prev], sc[k1]),
                "conv2": _qconv(spp[f"res{b}"]["conv2"], sc[k1], sc[k2]),
                # identity branch rescaled into conv2's output domain
                "res_scale": sc[prev] / sc[k2],
            }
            prev = k2
        qb[f"stage{i}"] = qst
        if i >= 2:
            route_keys.append(prev)
    q["backbone"] = qb
    q["route_scales"] = tuple(sc[k] for k in route_keys)

    def qhead(hname, in_key):
        hp = folded[hname]
        out: Dict = {}
        prev = in_key
        for i in range(6):
            key = f"{hname}/conv{i}"
            out[f"conv{i}"] = _qconv(hp[f"conv{i}"], sc[prev], sc[key])
            prev = key
        out["det"] = _qconv(hp["det"], sc[prev], None)
        return out

    k3, k4, k5 = route_keys
    q["head0"] = qhead("head0", k5)
    q["up0"] = {"conv": _qconv(folded["up0"]["conv"], sc["head0/conv4"], sc["up0/conv"])}
    q["head1"] = qhead("head1", "concat1")
    q["up1"] = {"conv": _qconv(folded["up1"]["conv"], sc["head1/conv4"], sc["up1/conv"])}
    q["head2"] = qhead("head2", "concat2")
    return q


def build_quantized(params, state, calib_x: torch.Tensor,
                    space_to_depth: bool = True) -> Dict:
    """Fold BN (+ the s2d remap), calibrate on ``calib_x`` [B, H, W, 3] in
    float32 with TF32 off, quantize.  ``params``/``state`` are torch trees
    on ``calib_x``'s device."""
    folded = D.fold_batchnorm(D.cast_params(params, torch.float32, calib_x.device),
                              D.cast_params(state, torch.float32, calib_x.device))
    if space_to_depth:
        folded = D.fold_space_to_depth(folded)
    with full_fp32(), torch.no_grad():
        stats = calibrate_yolonet(folded, calib_x)
    stats = {k: np.asarray(v.cpu(), np.float32) for k, v in stats.items()}
    return quantize_yolonet(D.map_tree(lambda t: t.cpu(), folded), stats)


# ---------------------------------------------------------------------------
# Elementwise pieces of the forward
# ---------------------------------------------------------------------------

def quantize_image(x: torch.Tensor, s_image: float) -> torch.Tensor:
    """float image -> int8 codes: clip(round(x / s_image)).  The divisor is a
    tensor on x's device, so CUDA divides (by a Python scalar it would
    multiply by the reciprocal, which can move a code); ``torch.full`` makes
    it there without a host-to-device copy."""
    s = torch.full((), s_image, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _requant(x_q: torch.Tensor, s_from: float, s_to: float) -> torch.Tensor:
    return torch.clamp(torch.round(x_q.float() * (s_from / s_to)),
                       -127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# The serving artifact (``yolo_v3_tpu/quantized-v1``, shared with JAX)
# ---------------------------------------------------------------------------

def _flatten_q(node, parts, names, kinds, arrays):
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten_q(node[k], parts + [k], names, kinds, arrays)
        return
    # leaf kinds: array, Python float (res_scale, scales/*) or tuple of
    # floats (route_scales); the kind lets load restore the Python type
    if isinstance(node, tuple):
        kind, arr = "tuple", np.asarray(node, np.float32)
    elif isinstance(node, (float, int)):
        kind, arr = "float", np.asarray(node, np.float32)
    else:
        kind = "array"
        arr = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) \
            else np.asarray(node)
    names.append(parts)
    kinds.append(kind)
    arrays.append(arr)


def save_quantized(q: Dict, path: str, meta: Dict = None) -> None:
    """Write a quantized serving tree as the JAX package's npz artifact:
    arrays under positional keys plus a JSON table of names and kinds."""
    names, kinds, arrays = [], [], []
    _flatten_q(q, [], names, kinds, arrays)
    header = {"format": QUANTIZED_FORMAT, "names": names, "kinds": kinds,
              "meta": meta or {}}
    flat = {f"a{i}": a for i, a in enumerate(arrays)}
    flat["__quantized__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def is_quantized_file(path: str) -> bool:
    """True if ``path`` is an npz written by :func:`save_quantized` (either
    package's)."""
    npz = path if path.endswith(".npz") else path + ".npz"
    try:
        with np.load(npz, allow_pickle=False) as z:
            return "__quantized__" in z.files
    except (OSError, ValueError):
        return False


def load_quantized(path: str) -> Dict:
    """Load a quantized serving tree: tensors on the CPU, Python floats, a
    tuple of floats, each leaf of the kind it was saved as."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz, allow_pickle=False) as z:
        if "__quantized__" not in z.files:
            raise ValueError(f"{path}: not a quantized serving artifact")
        header = json.loads(bytes(z["__quantized__"].tolist()).decode())
        if header.get("format") != QUANTIZED_FORMAT:
            raise ValueError(f"{path}: unknown quantized format {header.get('format')!r}")
        arrays = [z[f"a{i}"] for i in range(len(header["names"]))]
    q: Dict = {}
    for parts, kind, arr in zip(header["names"], header["kinds"], arrays):
        node = q
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if kind == "tuple":
            node[parts[-1]] = tuple(float(v) for v in arr)
        elif kind == "float":
            node[parts[-1]] = float(arr)
        else:
            node[parts[-1]] = torch.from_numpy(arr)
    return q


def qtree_from_numpy(tree) -> Dict:
    """A JAX quantized tree (after ``jax.device_get`` or ``np.asarray`` on its
    leaves) -> the port's: arrays become CPU tensors bit for bit, scalars
    (0-d arrays included) Python floats, tuples tuples of floats."""
    if isinstance(tree, dict):
        return {k: qtree_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(float(v) for v in tree)
    if isinstance(tree, (float, int)) or np.ndim(tree) == 0:
        return float(tree)
    return torch.from_numpy(np.array(tree, copy=True))


# ---------------------------------------------------------------------------
# The quantized forward
# ---------------------------------------------------------------------------

class Int8Ops(NamedTuple):
    """The kernel entry points of the int8 forward."""
    entry: object
    conv1x1: object
    conv3x3: object
    res_block: object


KERNELS = Int8Ops(EK.fused_entry, FC.conv1x1_p2d, FC.conv3x3_p2d, FC.res_block_p2d)
PLAIN = Int8Ops(EK.fused_entry_ref, FC.conv1x1_p2d_ref, FC.conv3x3_p2d_ref,
                FC.res_block_p2d_ref)


# The entry on a stripe of rows.  Output row i (stride 4) reads image rows
# 4i-11 .. 4i+10: the stem is a 3x3 VALID conv over the 2x2 blocks of the
# image padded by 1 row on top and 3 below, then down0 (3x3/2), res0_2
# (3x3) and down1 (2x2, pad (1, 0)).  A window keeps the whole image's 2x2
# blocks and down0's pairs of them only if it starts 4k + 1 rows above the
# stripe (the image's 1-row pad is k = 0), so an inner top edge takes the
# 13 rows above (the least such start over 11 rows) and an inner bottom
# edge the 7 below (to 4i+10 of the stripe's last row, which keeps the
# window a multiple of 4 rows high).  The entry's own zero padding of
# down0, res0_2 and down1 at the window's edges then makes its first 3
# output rows ((13 - 1) / 4, the rows above the stripe's) and its last one
# wrong at an inner edge: they are cut.
ENTRY_PAD = (1, 3)          # the image's pad rows at its real top / bottom
ENTRY_HALO = (13, 7)        # image rows of the neighbours at an inner top / bottom
ENTRY_CUT = (3, 1)          # output rows cut there


def inner_edges(mesh) -> Tuple[bool, bool]:
    """Whether this rank's stripe has a neighbour above and below (False,
    False off a ``space`` mesh)."""
    if not D._space_sharded(mesh):
        return False, False
    return mesh.space_index > 0, mesh.space_index < mesh.space_size - 1


def entry_window(codes: torch.Tensor, above=None, below=None) -> torch.Tensor:
    """The padded image one entry launch runs on, before its space-to-depth:
    ``codes`` [B, S, W, 3], a stripe of image codes (one byte a pixel: the
    int8 codes of the float feed, the raw bytes of the uint8 feed), with
    ``above`` / ``below``, the :data:`ENTRY_HALO` rows of the neighbouring
    stripes at an inner edge, or None at the image's real top / bottom,
    which gets the whole image's :data:`ENTRY_PAD` rows of 0; the columns
    padded (1, 3) with 0.  With both None it is the whole image's padded
    image.  The entry's output on it has :data:`ENTRY_CUT` rows too many at
    each inner edge (:func:`cut_entry`)."""
    for rows, want, side in ((above, ENTRY_HALO[0], "above"), (below, ENTRY_HALO[1], "below")):
        if rows is not None and rows.shape[1] != want:
            raise ValueError(f"the entry window takes {want} rows {side} a stripe, "
                             f"got {rows.shape[1]}")
    top = 0 if above is not None else ENTRY_PAD[0]
    bottom = 0 if below is not None else ENTRY_PAD[1]
    rows = torch.cat([t for t in (above, codes, below) if t is not None], dim=1)
    return F.pad(rows, (0, 0, 1, 3, top, bottom))


def cut_entry(out: torch.Tensor, inner_top: bool, inner_bottom: bool) -> torch.Tensor:
    """The stripe's rows of the entry's output on :func:`entry_window`."""
    top, bottom = ENTRY_CUT[0] * inner_top, ENTRY_CUT[1] * inner_bottom
    return out.narrow(1, top, out.shape[1] - top - bottom)


class _QConv(nn.Module):
    """One quantized conv: int8 weight (kept HWIO, or [C, N] for a 1x1),
    float32 multiplier and bias."""

    def __init__(self, p: Dict):
        super().__init__()
        w = p["w"]
        if w.dim() == 4 and w.shape[:2] == (1, 1):
            w = w.reshape(w.shape[2], w.shape[3])
        self.register_buffer("w", w.to(torch.int8).contiguous())
        self.register_buffer("m", p["m"].to(torch.float32).contiguous())
        self.register_buffer("b", p["b"].to(torch.float32).contiguous())

    def p2d(self, fn, x2d, hp, wp, **kw):
        return fn(x2d, self.w, self.m, self.b, hp, wp, **kw)

    def nhwc(self, x, stride=1, mesh=None):
        """The NHWC SAME conv (a 3x3 here: the stem of a tree without s2d, a
        stride-2 down).  Under a ``space`` mesh ``x`` is a stripe: it reads a
        row of the stripe above and, at stride 1, one of the stripe below
        (zeros at the image's real edges, the conv's padding), and pads W
        only; output row i of stride 2 reads rows 2i-1 .. 2i+1, so nothing
        below."""
        padding = None
        if D._space_sharded(mesh):
            above, below = edge_rows(x, mesh, 1, 1 if stride == 1 else 0, dim=1)
            x, padding = torch.cat([above, x, below], dim=1), ((0, 0), (1, 1))
        return FC.conv_i8_nhwc(x, self.w, self.m, self.b, stride=stride, padding=padding)


class _QResBlock(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.conv1 = _QConv(p["conv1"])
        self.conv2 = _QConv(p["conv2"])
        self.res_scale = float(p["res_scale"])

    def forward(self, x2d, hp, wp, ops: Int8Ops, mesh=None):
        """``mesh``: under ``space`` > 1 the 3x3 reads the neighbouring
        stripes' rows of the 1x1's output, written into its border rows
        between the two launches (``darknet.p2d_halo_rows``)."""
        c1, c2 = self.conv1, self.conv2
        border = (functools.partial(D.p2d_halo_rows, hp=hp, wp=wp, mesh=mesh)
                  if D._space_sharded(mesh) else None)
        return ops.res_block(x2d, c1.w, c1.m, c1.b, c2.w, c2.m, c2.b, hp, wp,
                             res_scale=self.res_scale, border=border)


class _QHead(nn.Module):
    def __init__(self, hq: Dict):
        super().__init__()
        self.convs = nn.ModuleList(_QConv(hq[f"conv{i}"]) for i in range(6))
        self.det = _QConv(hq["det"])

    def forward(self, x2d, hp, wp, ops: Int8Ops, mesh=None):
        """``mesh``: under ``space`` > 1 each 3x3 reads the neighbouring
        stripes' rows in its border rows (``darknet.p2d_halo_rows``)."""
        y = x2d
        for i, conv in enumerate(self.convs):
            if i % 2:
                y = D.p2d_halo_rows(y, hp, wp, mesh)
            y = conv.p2d(ops.conv3x3 if i % 2 else ops.conv1x1, y, hp, wp)
            if i == 4:
                branch = y
        det = self.det.p2d(ops.conv1x1, y, hp, wp, leaky=False,
                           out_dtype=torch.bfloat16)
        return det, branch


_U8_NEEDS_S2D = ("the uint8 feed needs a quantized tree with s2d and 's2d/stem4_u8' "
                 "(build_quantized's default)")


class YoloNetQuantized(nn.Module):
    """The int8 forward of a quantized tree: the JAX
    ``apply_yolonet_quantized`` (float image) and, for an s2d tree,
    ``apply_yolonet_quantized_u8`` (uint8 image).

    ``forward(x)`` takes a [B, H, W, 3] image batch (H, W multiples of 32),
    float in [0, 1] or uint8, and returns the three raw heads, coarse first,
    bf16 NHWC.  An s2d tree runs its entry on ``fused_entry``; a tree without
    s2d runs its stem and stage 0's downsample as plain int8 convs and stage
    0's residual block on the p2d kernels like every other block.
    ``plain=True`` runs the kernels' plain versions instead.
    ``forward(x, mesh=...)`` with a ``(data, space)`` mesh of ``space`` > 1
    takes this rank's stripe of the images' rows and returns the whole
    heads on every rank of its space group (module doc).

    The uint8 feed: ``u8 ^ 0x80`` read as int8 is the quantized image (scale
    1/255, zero point folded into ``stem4_u8``'s bias), padded with -128.
    ``stem4_u8`` is the stem tiled over 4x4 blocks: the same filters, so the
    same weight codes and per-channel scales as the 2x2 stem, and its
    multiplier and bias are a tile of one per-channel vector.  The entry
    therefore runs the 2x2 stem's weights with the first 128 of them (the
    2x2 stem's channel order); the constructor checks the tiling.
    """

    def __init__(self, q: Dict):
        super().__init__()
        self.scales = {k: float(v) for k, v in q["scales"].items()}
        self.route_scales = tuple(float(s) for s in q["route_scales"])
        qb = q["backbone"]
        self.has_s2d = "s2d" in q
        if self.has_s2d:
            self.entry = nn.ModuleDict({k: _QConv(q["s2d"][k]) for k in EK.CONVS})
            self.entry_res_scale = self.scales["s2d/down0"] / self.scales["s2d/res0_2"]
            self.stem_u8 = _QConv(_stem_u8(q["s2d"])) if "stem4_u8" in q["s2d"] else None
        else:
            self.stem = _QConv(qb["stem"])
        stages = sorted(int(k[5:]) for k in qb if k.startswith("stage"))
        first = 1 if self.has_s2d else 0
        if stages != list(range(first, first + len(stages))):
            raise ValueError(f"a{'n s2d' if self.has_s2d else ' plain'} tree's backbone "
                             f"runs stages {first}.., got {stages}")
        self.first_stage = first
        self.downs = nn.ModuleList()
        self.stages = nn.ModuleList()
        for i in stages:
            qst = qb[f"stage{i}"]
            self.downs.append(_QConv(qst["down"]) if "down" in qst else nn.Identity())
            nblk = sum(1 for k in qst if k.startswith("res"))
            self.stages.append(nn.ModuleList(_QResBlock(qst[f"res{b}"])
                                             for b in range(nblk)))
        self.head0 = _QHead(q["head0"])
        self.up0 = _QConv(q["up0"]["conv"])
        self.head1 = _QHead(q["head1"])
        self.up1 = _QConv(q["up1"]["conv"])
        self.head2 = _QHead(q["head2"])

    @property
    def num_res_blocks(self) -> int:
        return sum(len(s) for s in self.stages)

    def entry_operands(self, x: torch.Tensor, mesh=None):
        """An s2d tree's ``fused_entry`` operands for the image batch ``x``
        (float or uint8): the space-to-depth image codes ``xb`` and the
        entry's convs, the uint8 feed's stem in place of ``stem``.  Under a
        ``space`` mesh ``x`` is a stripe and ``xb`` its window
        (:func:`entry_window`), whose rows the stripes swap as one byte a
        pixel: the float feed's int8 codes, the uint8 feed's raw bytes.
        The uint8 feed's ``u8 ^ 0x80`` turns the window's 0 pad into -128."""
        if x.dtype == torch.uint8:
            if self.stem_u8 is None:
                raise ValueError(_U8_NEEDS_S2D)
            codes, stem = x, self.stem_u8
        else:
            codes, stem = quantize_image(x, self.scales["image"]), self.entry["stem"]
        above = below = None
        inner_top, inner_bottom = inner_edges(mesh)
        if inner_top or inner_bottom:
            above, below = edge_rows(codes, mesh, *ENTRY_HALO, dim=1)
            above, below = (above if inner_top else None), (below if inner_bottom else None)
        window = entry_window(codes, above, below)
        if x.dtype == torch.uint8:
            window = (window ^ 0x80).view(torch.int8)
        xb = D._space_to_depth2(window).contiguous()
        qs2d = {k: {"w": c.w, "m": c.m, "b": c.b} for k, c in self.entry.items()}
        qs2d["stem"] = {"w": stem.w, "m": stem.m, "b": stem.b}
        return xb, qs2d

    def _entry(self, x: torch.Tensor, ops: "Int8Ops", mesh) -> torch.Tensor:
        """Image (or stripe) -> the input of the first stage that the tail
        runs."""
        if self.has_s2d:
            out = ops.entry(*self.entry_operands(x, mesh), self.entry_res_scale)
            return cut_entry(out, *inner_edges(mesh))
        if x.dtype == torch.uint8:
            raise ValueError(_U8_NEEDS_S2D)
        return self.stem.nhwc(quantize_image(x, self.scales["image"]), mesh=mesh)

    def forward(self, x: torch.Tensor, plain: bool = False, mesh=None):
        ops = PLAIN if plain else KERNELS
        sc = self.scales
        y = self._entry(x, ops, mesh)

        routes = []
        for i, (down, blocks) in enumerate(zip(self.downs, self.stages),
                                           start=self.first_stage):
            if isinstance(down, _QConv):
                y = down.nhwc(y, stride=2, mesh=mesh)
            b, h, w, _ = y.shape
            _, hp, wp = FC.p2d_geometry(b, h, w)
            y2d = FC.pack_p2d(y)
            for blk in blocks:
                y2d = blk(y2d, hp, wp, ops, mesh)
            y = FC.unpack_p2d(y2d, b, h, w)
            if i >= 2:
                routes.append(y2d)
        c3, c4, c5 = routes
        s_c3, s_c4, _ = self.route_scales
        # (B, H, W) of the routes at strides 32, 16 and 8
        g5, g4, g3 = ((x.shape[0], x.shape[1] // s, x.shape[2] // s) for s in (32, 16, 8))

        def up_concat(up, br2d, route2d, g_small, g_big, s_up, s_route, s_cat):
            u = up.p2d(ops.conv1x1, br2d, g_small[1] + 2, g_small[2] + 2)
            # requantizing before the upsample gives the same codes as after
            # it (elementwise), on a quarter of the elements
            u = D.upsample2x_nearest(_requant(FC.unpack_p2d(u, *g_small), s_up, s_cat))
            r = _requant(FC.unpack_p2d(route2d, *g_big), s_route, s_cat)
            return FC.pack_p2d(torch.cat([u, r], dim=-1))

        det0, br0 = self.head0(c5, g5[1] + 2, g5[2] + 2, ops, mesh)
        y2d = up_concat(self.up0, br0, c4, g5, g4, sc["up0/conv"], s_c4, sc["concat1"])
        det1, br1 = self.head1(y2d, g4[1] + 2, g4[2] + 2, ops, mesh)
        y2d = up_concat(self.up1, br1, c3, g4, g3, sc["up1/conv"], s_c3, sc["concat2"])
        det2, _ = self.head2(y2d, g3[1] + 2, g3[2] + 2, ops, mesh)
        heads = tuple(FC.unpack_p2d(d, *g).contiguous()
                      for d, g in ((det0, g5), (det1, g4), (det2, g3)))
        if D._space_sharded(mesh):
            heads = tuple(gather_rows(h, mesh) for h in heads)
        return heads


def _stem_u8(qs: Dict) -> Dict:
    """The 2x2 stem of the uint8 feed: ``stem``'s int8 weight with the first
    128 of ``stem4_u8``'s multipliers and biases, after checking that both
    are one per-channel vector tiled over the 16 positions of a 4x4 block
    and that the two stems hold the same weight codes."""
    w2, w4 = qs["stem"]["w"], qs["stem4_u8"]["w"]
    m4, b4 = qs["stem4_u8"]["m"], qs["stem4_u8"]["b"]
    c2 = w2.shape[-1]
    c1 = c2 // 4
    for name, v in (("m", m4), ("b", b4)):
        if not torch.equal(v.reshape(16, c1), v[:c1].expand(16, c1)):
            raise ValueError(f"stem4_u8's {name} is not a tile of {c1} channels")
    if not torch.equal(w2.to(torch.int32).sum((0, 1, 2)),
                       w4.to(torch.int32).sum((0, 1, 2))[:c2]):
        raise ValueError("stem and stem4_u8 hold different weight codes")
    return {"w": w2, "m": m4[:c2].clone(), "b": b4[:c2].clone()}


# ---------------------------------------------------------------------------
# Per-layer int8 helpers: the scheme above, one layer at a time, with a float
# output (the JAX package's standalone building blocks).
# ---------------------------------------------------------------------------

def quantize_weights_per_channel(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """[kh, kw, cin, cout] float -> (int8 weights, float32 scale [cout])."""
    w = torch.as_tensor(w, dtype=torch.float32)
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def activation_scale(x_absmax) -> torch.Tensor:
    """Per-tensor activation scale from a calibrated abs-max."""
    return torch.clamp(torch.as_tensor(x_absmax, dtype=torch.float32) / 127.0, min=1e-12)


def quantize_activation(x: torch.Tensor, scale) -> torch.Tensor:
    """float -> int8 codes: clip(round(x / scale))."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def conv_int8_bias_leaky(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale: torch.Tensor,
                         b: torch.Tensor, stride: int = 1, leaky: bool = True,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """One int8 SAME conv (NHWC ``x_q``, HWIO ``w_q``) with an exact int32
    accumulator and a float epilogue, ``acc * (x_scale * w_scale) + b`` (+
    leaky), cast to ``out_dtype``: the float-out form of the serving convs,
    with no requantize."""
    acc = FC.conv_i8_acc(x_q, w_q, stride=stride)
    m = torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device) * w_scale.float()
    y = acc.float() * m + b.float()
    if leaky:
        y = torch.where(y > 0, y, FC.LEAKY * y)
    return y.to(out_dtype)


def quantized_block(x: torch.Tensor, p: Dict, x_absmax, stride: int = 1,
                    leaky: bool = True) -> torch.Tensor:
    """Quantize the activation and the weights, run the int8 conv: the int8
    twin of one folded float conv ``p`` = {w, b}, output in ``x``'s dtype."""
    w_q, w_s = quantize_weights_per_channel(p["w"])
    x_s = activation_scale(x_absmax)
    x_q = quantize_activation(x, x_s)
    return conv_int8_bias_leaky(x_q, w_q.to(x.device), x_s, w_s.to(x.device),
                                torch.as_tensor(p["b"]).to(x.device), stride, leaky,
                                out_dtype=x.dtype)


def calibrate_absmax(samples: torch.Tensor) -> torch.Tensor:
    """abs-max over a calibration batch (per tensor)."""
    return samples.abs().max()
