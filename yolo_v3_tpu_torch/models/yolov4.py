"""YOLOv4 in PyTorch: CSPDarknet53 with Mish, SPP and PANet (Bochkovskiy,
Wang, Liao, arXiv:2004.10934; darknet's ``cfg/yolov4.cfg``, layer for layer).

The parameter trees have the YOLOv3 trees' form (``models/darknet.py``:
nested dicts, HWIO conv weights, ``bn`` scale and bias, ``state`` mean and
var; the detection convs a bias and no BN), so the same BN fold
(``darknet.fold_batchnorm``) and casts apply.  :func:`conv_specs` lists the
110 convs in the cfg's order with their tree paths:

* ``backbone/stem`` (3x3, 32, Mish), then five CSP stages
  ``backbone/stage{i}``: ``down`` (3x3/2), the split pair ``split0`` (the
  part routed around the blocks) and ``split1`` (the part through them),
  the residual blocks ``res{b}`` (``conv1`` 1x1, ``conv2`` 3x3, then the
  shortcut: ``y + mish(conv2(mish(conv1(y))))``), ``trans`` (1x1), the
  concatenation [trans, split0] and ``fuse`` (1x1); all Mish.  Stage 0 is
  64 -> 64 / 64, its block 64 -> 32 -> 64; stages 1-4 halve the down's
  width for the split and keep it through their blocks (Cmid = C);
* the neck, all leaky(0.1): ``neck/spp_in`` (1x1, 3x3, 1x1) and SPP, the
  concatenation [maxpool 13, maxpool 9, maxpool 5, x] (stride 1, -inf
  padding), then ``neck/spp_out`` (1x1, 3x3, 1x1: P5); top-down, twice:
  ``neck/up{j}`` (1x1, nearest 2x upsample), ``neck/lat{j}`` (1x1 on the
  stage-3, then the stage-2 output), the concatenation [lat, up] and
  ``neck/td{j}`` (five convs: 1x1, 3x3, 1x1, 3x3, 1x1; P4, P3); the fine
  head ``head2`` (3x3, then ``det``: 1x1, bias, linear); bottom-up, twice:
  ``neck/down{j}`` (3x3/2), the concatenation [down, P4 or P5] and
  ``neck/bu{j}`` (five convs), each followed by its head (``head1``, then
  ``head0``).

Heads return coarse first (19, 38, 76 at 608) with anchor masks (6, 7, 8),
(3, 4, 5), (0, 1, 2) and ``scale_x_y`` :data:`SCALE_X_Y`, so the postprocess
takes them in YOLOv3's order.

:class:`YoloV4Folded` serves the BN-folded tree in bf16: the stem, the five
Mish downs and PANet's two leaky stride-2 convs on the conv kernel of
``ops/conv_down.py`` with one rounding (``darknet._ConvBias``), the 23 CSP
blocks on the fused residual-block kernel with Mish
(``ops/fused_res_block.py``), every other conv (the CSP
1x1s with Mish, the neck's 1x1s and 3x3s with leaky, the detection convs
linear) on the padded-2D kernels (``ops/fused_conv.py``), the split pair as
one launch with both weight sets, and SPP as ``max_pool2d`` (5, then 5 twice
more: exactly 9 and 13).  Activations between CSP convs stay in the
padded-2D layout; a forward converts between it and NHWC 32 times (a
``pack_p2d``, or an unpack copied to NHWC: per stage the down's output in,
the blocks' input out and their output in, 15; stages 0-3 the fuse's
output out, 4; in the neck SPP out and in, each upsample out and in, each
PANet down out and in, and the three heads out, 13).  The Mish kernels are bf16
only: a float32 tree runs only where the wrappers take their plain versions
(a CPU tensor), and raises on a card.  ``plain=True`` runs the plain
versions.  Marks ``yolo.backbone``, ``yolo.neck`` (SPP,
both paths and the heads) and, inside it, ``yolo.spp`` in a recording
profiler (``utils/profiling.py::span``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.ops import activations as A
from yolo_v3_tpu_torch.ops import fused_conv as FC
from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block, fused_res_block_ref
from yolo_v3_tpu_torch.utils.precision import full_fp32
from yolo_v3_tpu_torch.utils.profiling import span

Params = Dict[str, Any]

CSP_BLOCKS: Tuple[int, ...] = (1, 2, 8, 8, 4)
ANCHORS: Tuple[Tuple[float, float], ...] = (
    (12, 16), (19, 36), (40, 28),
    (36, 75), (76, 55), (72, 146),
    (142, 110), (192, 243), (459, 401),
)
ANCHOR_MASKS: Tuple[Tuple[int, ...], ...] = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
# per head, coarse first (yolov4.cfg gives 1.2, 1.1, 1.05 from the fine head)
SCALE_X_Y: Tuple[float, ...] = (1.05, 1.1, 1.2)
SPP_POOL = 5            # SPP's 5, 9 and 13 are this pool applied 1, 2 and 3 times


def conv_specs(num_classes: int = 80,
               blocks: Tuple[int, ...] = CSP_BLOCKS) -> List[Tuple[str, int, int, int, int, str]]:
    """The 110 convs of YOLOv4 in ``yolov4.cfg``'s order: (tree path, kernel
    size, input channels, output channels, stride, activation)."""
    out: List[Tuple[str, int, int, int, int, str]] = []

    def add(path, k, cin, cout, stride=1, act="mish"):
        out.append((path, k, cin, cout, stride, act))

    add("backbone/stem", 3, 3, 32)
    c = 32
    for i, n in enumerate(blocks):
        pre, cd = f"backbone/stage{i}", 2 * c
        part = cd if i == 0 else cd // 2
        mid = part // 2 if i == 0 else part
        add(f"{pre}/down", 3, c, cd, 2)
        add(f"{pre}/split0", 1, cd, part)
        add(f"{pre}/split1", 1, cd, part)
        for b in range(n):
            add(f"{pre}/res{b}/conv1", 1, part, mid)
            add(f"{pre}/res{b}/conv2", 3, mid, part)
        add(f"{pre}/trans", 1, part, part)
        add(f"{pre}/fuse", 1, 2 * part, cd)
        c = cd
    attrib = 3 * (5 + num_classes)

    def five(pre, cin, f):
        for j, (k, a, b) in enumerate(((1, cin, f), (3, f, 2 * f), (1, 2 * f, f),
                                       (3, f, 2 * f), (1, 2 * f, f))):
            add(f"{pre}/conv{j}", k, a, b, act="leaky")

    for j, (k, a, b) in enumerate(((1, c, 512), (3, 512, 1024), (1, 1024, 512))):
        add(f"neck/spp_in/conv{j}", k, a, b, act="leaky")
    for j, (k, a, b) in enumerate(((1, 2048, 512), (3, 512, 1024), (1, 1024, 512))):
        add(f"neck/spp_out/conv{j}", k, a, b, act="leaky")
    add("neck/up0", 1, 512, 256, act="leaky")
    add("neck/lat0", 1, 512, 256, act="leaky")
    five("neck/td0", 512, 256)
    add("neck/up1", 1, 256, 128, act="leaky")
    add("neck/lat1", 1, 256, 128, act="leaky")
    five("neck/td1", 256, 128)
    add("head2/conv", 3, 128, 256, act="leaky")
    add("head2/det", 1, 256, attrib, act="linear")
    add("neck/down0", 3, 128, 256, 2, act="leaky")
    five("neck/bu0", 512, 256)
    add("head1/conv", 3, 256, 512, act="leaky")
    add("head1/det", 1, 512, attrib, act="linear")
    add("neck/down1", 3, 256, 512, 2, act="leaky")
    five("neck/bu1", 1024, 512)
    add("head0/conv", 3, 512, 1024, act="leaky")
    add("head0/det", 1, 1024, attrib, act="linear")
    return out


def _node(tree, path: str):
    for key in path.split("/"):
        tree = tree.setdefault(key, {})
    return tree


def _get(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def init_yolov4(generator: torch.Generator, num_classes: int = 80,
                blocks: Tuple[int, ...] = CSP_BLOCKS, dtype: torch.dtype = torch.float32,
                device="cpu"):
    """(params, state) trees of YOLOv4 drawn from ``generator`` (on the CPU):
    Kaiming-uniform fan-in conv weights and identity BN, as
    ``darknet.init_yolonet``."""
    params: Params = {}
    state: Params = {}
    for path, k, cin, cout, _, act in conv_specs(num_classes, blocks):
        if act == "linear":
            _node(params, path).update(D._init_bias_conv(generator, k, cin, cout, dtype, device))
            continue
        p, s = D._init_cb(generator, k, cin, cout, dtype, device)
        _node(params, path).update(p)
        _node(state, path).update(s)
    return params, state


# ---------------------------------------------------------------------------
# The unfolded forward: conv + BatchNorm (running statistics) + activation
# ---------------------------------------------------------------------------

def _max_pools(x: torch.Tensor):
    """SPP's pools of an NCHW ``x`` at stride 1, -inf padding: (13, 9, 5),
    each the 5-pool of the one before."""
    m5 = F.max_pool2d(x, SPP_POOL, 1, SPP_POOL // 2)
    m9 = F.max_pool2d(m5, SPP_POOL, 1, SPP_POOL // 2)
    return F.max_pool2d(m9, SPP_POOL, 1, SPP_POOL // 2), m9, m5


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def apply_yolov4(params: Params, state: Params, x: torch.Tensor,
                 blocks: Tuple[int, ...] = CSP_BLOCKS):
    """The float forward of the unfolded trees in eval mode (BN with the
    running statistics): NHWC images -> the three NHWC raw heads, coarse
    first.  float32 with TF32 off."""
    acts = {path: (stride, act) for path, _, _, _, stride, act in
            conv_specs(params["head0"]["det"]["b"].shape[0] // 3 - 5, blocks)}

    def conv(path, y):
        p = _get(params, path)
        stride, act = acts[path]
        y = D._conv(y, p["w"], stride)
        if act == "linear":
            return y + p["b"][:, None, None]
        s = _get(state, path)
        inv = torch.rsqrt(s["var"] + D.BN_EPS) * p["bn"]["scale"]
        y = (y - s["mean"][:, None, None]) * inv[:, None, None] + p["bn"]["bias"][:, None, None]
        return A.apply(y, act)

    def chain(pre, y, n):
        for j in range(n):
            y = conv(f"{pre}/conv{j}", y)
        return y

    with full_fp32():
        y = conv("backbone/stem", x.permute(0, 3, 1, 2))
        routes = []
        for i, n in enumerate(blocks):
            pre = f"backbone/stage{i}"
            y = conv(f"{pre}/down", y)
            a, t = conv(f"{pre}/split0", y), conv(f"{pre}/split1", y)
            for b in range(n):
                t = t + conv(f"{pre}/res{b}/conv2", conv(f"{pre}/res{b}/conv1", t))
            y = conv(f"{pre}/fuse", torch.cat([conv(f"{pre}/trans", t), a], 1))
            routes.append(y)
        s2, s3, s4 = routes[-3:]
        x5 = chain("neck/spp_in", s4, 3)
        p5 = chain("neck/spp_out", torch.cat([*_max_pools(x5), x5], 1), 3)
        p4 = chain("neck/td0", torch.cat([conv("neck/lat0", s3),
                                          _upsample(conv("neck/up0", p5))], 1), 5)
        p3 = chain("neck/td1", torch.cat([conv("neck/lat1", s2),
                                          _upsample(conv("neck/up1", p4))], 1), 5)
        d2 = conv("head2/det", conv("head2/conv", p3))
        n4 = chain("neck/bu0", torch.cat([conv("neck/down0", p3), p4], 1), 5)
        d1 = conv("head1/det", conv("head1/conv", n4))
        n5 = chain("neck/bu1", torch.cat([conv("neck/down1", n4), p5], 1), 5)
        d0 = conv("head0/det", conv("head0/conv", n5))
    return tuple(d.permute(0, 2, 3, 1) for d in (d0, d1, d2))


# ---------------------------------------------------------------------------
# The folded forward on the kernels
# ---------------------------------------------------------------------------

class _P2d(D._P2dConv):
    """A stride-1 1x1 or 3x3 conv on the padded-2D layout with an activation
    by name; out in the weight's dtype."""

    def __init__(self, p: Params, act: str):
        super().__init__(p, leaky=act == "leaky")
        self.act = act

    def forward(self, x2d, g, plain):
        _, hp, wp = FC.p2d_geometry(*g)
        return self.fns[plain](x2d, self.weight, self.scale, self.bias, hp, wp, act=self.act,
                               out_dtype=self.weight.dtype)


class _Chain(nn.ModuleList):
    def forward(self, x2d, g, plain):
        for conv in self:
            x2d = conv(x2d, g, plain)
        return x2d


class _Block(D._ResBlock):
    """A CSP residual block on NHWC, Mish on both convs."""

    def forward(self, y, plain):
        fn = fused_res_block_ref if plain else fused_res_block
        return fn(y, self.w1, self.b1, self.w2, self.b2, act="mish")


class _CspStage(nn.Module):
    def __init__(self, sp: Params):
        super().__init__()
        self.down = D._ConvBias(sp["down"], 2, act="mish")
        self.part = sp["split0"]["w"].shape[-1]
        # the split pair reads one input: one launch, split0's channels first
        self.split = _P2d({k: torch.cat([sp["split0"][k], sp["split1"][k]], -1)
                           for k in ("w", "b")}, "mish")
        self.blocks = nn.ModuleList(_Block(sp[f"res{b}"]) for b in range(D._stage_blocks(sp)))
        self.trans = _P2d(sp["trans"], "mish")
        self.fuse = _P2d(sp["fuse"], "mish")

    def forward(self, x, plain):
        """NCHW (channels_last) in -> (the stage's output in the padded-2D
        layout, its [B, H, W])."""
        y = self.down(x, plain=plain).permute(0, 2, 3, 1)     # NHWC view
        g = tuple(y.shape[:3])
        ab = self.split(FC.pack_p2d(y), g, plain)
        t = FC.unpack_p2d(ab[:, self.part:], *g).contiguous()
        for blk in self.blocks:
            t = blk(t, plain)
        t = self.trans(FC.pack_p2d(t), g, plain)
        return self.fuse(torch.cat([t, ab[:, :self.part]], dim=1), g, plain), g


def _nchw(x2d, g) -> torch.Tensor:
    """A padded-2D tensor as NCHW (channels_last), copied out of the layout."""
    return FC.unpack_p2d(x2d, *g).contiguous().permute(0, 3, 1, 2)


class YoloV4Folded(nn.Module):
    """Inference YOLOv4 on BN-folded params (``darknet.fold_batchnorm``):
    ``forward(x)`` takes an NHWC image batch in the params' dtype and returns
    the three NHWC raw heads, coarse first (module docstring for the
    routes and kernels)."""

    def __init__(self, params: Params):
        super().__init__()
        bk, nk = params["backbone"], params["neck"]
        self.stem = D._ConvBias(bk["stem"], 1, act="mish")
        self.stages = nn.ModuleList(_CspStage(bk[f"stage{i}"]) for i in range(D._num_stages(bk)))

        def chain(pre, n):
            return _Chain(_P2d(nk[pre][f"conv{j}"], "leaky") for j in range(n))

        self.spp_in, self.spp_out = chain("spp_in", 3), chain("spp_out", 3)
        self.up0, self.lat0, self.td0 = (_P2d(nk["up0"], "leaky"), _P2d(nk["lat0"], "leaky"),
                                         chain("td0", 5))
        self.up1, self.lat1, self.td1 = (_P2d(nk["up1"], "leaky"), _P2d(nk["lat1"], "leaky"),
                                         chain("td1", 5))
        self.down0, self.bu0 = D._ConvBias(nk["down0"], 2, act="leaky"), chain("bu0", 5)
        self.down1, self.bu1 = D._ConvBias(nk["down1"], 2, act="leaky"), chain("bu1", 5)
        self.heads = nn.ModuleList(
            _Chain([_P2d(params[h]["conv"], "leaky"), _P2d(params[h]["det"], "linear")])
            for h in ("head0", "head1", "head2"))

    def forward(self, x: torch.Tensor, plain: bool = False):
        with span("backbone"):
            y = self.stem(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last),
                          plain=plain)
            routes = []
            for i, stage in enumerate(self.stages):
                f2d, g = stage(y, plain)
                routes.append((f2d, g))
                if i + 1 < len(self.stages):
                    y = _nchw(f2d, g)
        with span("neck"):
            heads = self._neck(routes[-3:], plain)
        return tuple(FC.unpack_p2d(d, *g).contiguous() for d, g in heads)

    def _neck(self, routes, plain):
        (s2, g2), (s3, g3), (s4, g4) = routes

        def up(conv, x2d, g):
            u = FC.unpack_p2d(conv(x2d, g, plain), *g)
            return FC.pack_p2d(D.upsample2x_nearest(u))

        def down(conv, x2d, g):
            return FC.pack_p2d(conv(_nchw(x2d, g), plain=plain).permute(0, 2, 3, 1))

        x5 = self.spp_in(s4, g4, plain)
        with span("spp"):
            u = FC.unpack_p2d(x5, *g4).permute(0, 3, 1, 2)
            pooled = torch.cat([*_max_pools(u), u], 1).permute(0, 2, 3, 1)
        p5 = self.spp_out(FC.pack_p2d(pooled), g4, plain)
        p4 = self.td0(torch.cat([self.lat0(s3, g3, plain), up(self.up0, p5, g4)], 1), g3, plain)
        p3 = self.td1(torch.cat([self.lat1(s2, g2, plain), up(self.up1, p4, g3)], 1), g2, plain)
        d2 = self.heads[2](p3, g2, plain)
        n4 = self.bu0(torch.cat([down(self.down0, p3, g2), p4], 1), g3, plain)
        d1 = self.heads[1](n4, g3, plain)
        n5 = self.bu1(torch.cat([down(self.down1, n4, g3), p5], 1), g4, plain)
        d0 = self.heads[0](n5, g4, plain)
        return (d0, g4), (d1, g3), (d2, g2)
