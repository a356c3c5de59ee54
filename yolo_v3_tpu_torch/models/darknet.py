"""YOLOv3 model core in PyTorch: Darknet-53 backbone + 3-scale heads.

Port of ``yolo_v3_tpu/models/darknet.py`` (init, the training forward with
BatchNorm in train or eval mode, BN re-estimation, BN folding and the folded
inference forward).  Parameters are nested dicts of tensors with the JAX
package's tree layout and HWIO conv weights, so the same trees move between
the packages (``models/weights.py``).  :class:`YoloNetFolded` takes NHWC
images and returns NHWC raw heads; inside, activations are NCHW tensors in
``torch.channels_last`` memory format, which is physically NHWC.

Every residual block runs on :func:`~yolo_v3_tpu_torch.ops.fused_res_block.
fused_res_block`, the hand-written CUDA kernel on a card.  In bf16 the stem
and the stride-2 downsamples run on the conv kernel of
:mod:`~yolo_v3_tpu_torch.ops.conv_down`, and the heads, their detection
convs and the two upsample convs on the padded-2D kernels
(:mod:`~yolo_v3_tpu_torch.ops.fused_conv`), which add the bias and apply
leaky in float32 and round once, as the reference's ``_conv_bias_leaky``
does; in fp32 they run on ``F.conv2d``, and the whole forward runs with TF32
off.  The space-to-depth weight folds, from which the int8 tree's entry is
built, are at the end.

Both forwards take a ``(data, space)`` mesh (``parallel/mesh.py``).
Under ``space`` > 1 the input is this rank's stripe of the images' rows;
before every 3x3 conv the stripe is extended by its neighbours' rows
(``parallel/halo.py``), so the conv pads W only, and a residual block runs
its kernel on the stripe extended by a row on each inner side and is cut
back after.  The 1x1 convs, the upsamples and the concats stay local.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_v3_tpu_torch.ops import conv_down as CD
from yolo_v3_tpu_torch.ops import fused_conv as FC
from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block, fused_res_block_ref
from yolo_v3_tpu_torch.parallel.halo import edge_rows, gather_rows, halo_exchange
from yolo_v3_tpu_torch.utils.precision import full_fp32

Params = Dict[str, Any]
State = Dict[str, Any]

# Residual-block counts of the 5 darknet-53 stages (reference darknet.py:179).
DARKNET53_BLOCKS: Tuple[int, ...] = (1, 2, 8, 8, 4)

LEAKY_SLOPE = 0.1
BN_EPS = 1e-5
BN_MOMENTUM = 0.1    # torch BatchNorm2d default: new = (1-m)*old + m*batch


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2 - 1) * bound).to(device=device, dtype=dtype)


def _init_cb(gen, ks, cin, cout, dtype, device):
    """conv + batchnorm block: Kaiming-uniform fan-in HWIO weight (torch
    Conv2d's default scale), identity BN."""
    bound = math.sqrt(1.0 / (cin * ks * ks))
    p = {
        "w": _uniform(gen, (ks, ks, cin, cout), bound, dtype, device),
        "bn": {"scale": torch.ones(cout, dtype=dtype, device=device),
               "bias": torch.zeros(cout, dtype=dtype, device=device)},
    }
    s = {"mean": torch.zeros(cout, dtype=dtype, device=device),
         "var": torch.ones(cout, dtype=dtype, device=device)}
    return p, s


def _init_bias_conv(gen, ks, cin, cout, dtype, device):
    """Final detection conv: bias on, no BN."""
    bound = math.sqrt(1.0 / (cin * ks * ks))
    return {"w": _uniform(gen, (ks, ks, cin, cout), bound, dtype, device),
            "b": _uniform(gen, (cout,), bound, dtype, device)}


def _init_head(gen, cin, nfilter, num_classes, dtype, device):
    params: Params = {}
    state: State = {}
    nin = cin
    for i in range(3):
        params[f"conv{2*i}"], state[f"conv{2*i}"] = _init_cb(
            gen, 1, nin, nfilter, dtype, device)
        params[f"conv{2*i+1}"], state[f"conv{2*i+1}"] = _init_cb(
            gen, 3, nfilter, nfilter * 2, dtype, device)
        nin = nfilter * 2
    params["det"] = _init_bias_conv(gen, 1, nin, (num_classes + 5) * 3,
                                    dtype, device)
    return params, state


def init_yolonet(
    generator: torch.Generator,
    num_classes: int = 80,
    blocks: Tuple[int, ...] = DARKNET53_BLOCKS,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Tuple[Params, State]:
    """Full 3-scale YOLOv3 params/state trees, drawn from ``generator`` (on
    the CPU, so a seed gives the same weights on every device).  Same tree
    structure and init scales as the JAX ``init_yolonet``; the random
    numbers differ, since the two frameworks' generators do."""
    params: Params = {}
    state: State = {}
    bk_p: Params = {}
    bk_s: State = {}
    bk_p["stem"], bk_s["stem"] = _init_cb(generator, 3, 3, 32, dtype, device)
    nin = 32
    for i, nblk in enumerate(blocks):
        sp: Params = {}
        ss: State = {}
        sp["down"], ss["down"] = _init_cb(generator, 3, nin, nin * 2, dtype, device)
        nout = nin * 2
        for b in range(nblk):
            c1, s1 = _init_cb(generator, 1, nout, nout // 2, dtype, device)
            c2, s2 = _init_cb(generator, 3, nout // 2, nout, dtype, device)
            sp[f"res{b}"] = {"conv1": c1, "conv2": c2}
            ss[f"res{b}"] = {"conv1": s1, "conv2": s2}
        bk_p[f"stage{i}"], bk_s[f"stage{i}"] = sp, ss
        nin = nout
    params["backbone"], state["backbone"] = bk_p, bk_s
    params["head0"], state["head0"] = _init_head(
        generator, 1024, 512, num_classes, dtype, device)
    up0 = _init_cb(generator, 1, 512, 256, dtype, device)
    params["up0"], state["up0"] = {"conv": up0[0]}, {"conv": up0[1]}
    params["head1"], state["head1"] = _init_head(
        generator, 768, 256, num_classes, dtype, device)
    up1 = _init_cb(generator, 1, 256, 128, dtype, device)
    params["up1"], state["up1"] = {"conv": up1[0]}, {"conv": up1[1]}
    params["head2"], state["head2"] = _init_head(
        generator, 384, 128, num_classes, dtype, device)
    return params, state


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------

def fold_batchnorm(params: Params, state: State) -> Params:
    """Fold every conv+BN pair into conv(w', b'): w' = w * scale/sqrt(var+eps),
    b' = bias - mean * scale/sqrt(var+eps).  Detection convs pass through."""

    def fold(p, s):
        if "bn" in p:
            inv = 1.0 / torch.sqrt(s["var"] + BN_EPS) * p["bn"]["scale"]
            return {"w": p["w"] * inv, "b": p["bn"]["bias"] - s["mean"] * inv}
        if "b" in p:
            return {"w": p["w"], "b": p["b"]}
        return {k: fold(p[k], s.get(k, {})) for k in p}

    return fold(params, state)


def map_tree(fn: Callable[..., torch.Tensor], tree, *rest):
    """``fn`` on the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(t[k] for t in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def cast_params(params: Params, dtype: torch.dtype, device=None) -> Params:
    return map_tree(lambda a: a.to(device=device, dtype=dtype), params)


def _stage_blocks(stage_params: Params) -> int:
    return sum(1 for k in stage_params if k.startswith("res"))


def _num_stages(backbone_params: Params) -> int:
    return sum(1 for k in backbone_params if k.startswith("stage"))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor (a broadcast copy, so
    its gradient is a plain sum, deterministic on the card too)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


# ---------------------------------------------------------------------------
# Training forward (the JAX ``apply_yolonet``): conv + BatchNorm + leaky with
# batch statistics in train mode, running statistics in eval mode.
# Activations are NCHW tensors in channels_last memory format; params and
# state are the same trees as above, with HWIO conv weights.
# ---------------------------------------------------------------------------

def _space_sharded(mesh) -> bool:
    return mesh is not None and mesh.space_size > 1


def _halo(x: torch.Tensor, stride: int, mesh) -> torch.Tensor:
    """A stripe of NCHW rows with the halo a 3x3 conv of ``stride`` reads
    beyond it: a row above and a row below at stride 1; a row above at
    stride 2, whose output row i reads input rows 2i-1 .. 2i+1 (stripes
    start on even rows).  The conv then pads W only."""
    return halo_exchange(x, mesh, 1, 1 if stride == 1 else 0)


def p2d_halo_rows(x2d: torch.Tensor, hp: int, wp: int, mesh=None) -> torch.Tensor:
    """Under a ``space`` > 1 ``mesh``, ``x2d`` (a stripe in the padded-2D
    layout) with the rows of the neighbouring stripes written into its top
    and bottom border rows, in place, where a 3x3's taps read them (zeros
    at the image's real edges; :func:`~yolo_v3_tpu_torch.ops.fused_conv.
    set_border_rows`); ``x2d`` as it is otherwise."""
    if not _space_sharded(mesh):
        return x2d
    b, h, w = x2d.shape[0] // (hp * wp), hp - 2, wp - 2
    above, below = edge_rows(FC.unpack_p2d(x2d, b, h, w), mesh, 1, 1, dim=1)
    return FC.set_border_rows(x2d, above, below, hp, wp)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, mesh=None) -> torch.Tensor:
    """'SAME' conv of an NCHW x by an HWIO weight, in x's dtype (bf16 out
    for bf16 operands, as the reference's ``f32_out=False``).  Under a
    ``space`` > 1 ``mesh``, x is a stripe of rows and a 3x3 conv reads its
    neighbours' rows through :func:`_halo`."""
    pad = (w.shape[0] - 1) // 2
    if pad and _space_sharded(mesh):
        return F.conv2d(_halo(x, stride, mesh), w.permute(3, 2, 0, 1), None, stride, (0, pad))
    return F.conv2d(x, w.permute(3, 2, 0, 1), None, stride, pad)


# under a space axis the pixel count rides in the statistics' all-reduce as
# two float parts, each summed exactly: count // 2**12 and count % 2**12
_COUNT_SPLIT = 4096


def _global_mean_var(y: torch.Tensor, mesh):
    """Per-channel mean and biased variance of an NCHW ``y`` over the batch
    of every rank of ``mesh.bn_group``: ``mean = sum(y) / N``, then ``var =
    sum((y - mean)^2) / N``, each sum all-reduced.  On a data axis alone the
    shards are equal and N is the local count times the world size, known on
    the host.  The stripes of a ``space`` axis may differ in height, so there
    N is summed in the first all-reduce; its two parts are made by fill
    kernels, since a tensor built from a host list is a blocking copy that
    would wait for the stream at every BN layer.  Returns (mean, var, N: an
    int, or a float64 scalar tensor under ``space``)."""
    from torch.distributed.nn.functional import all_reduce

    group = mesh.bn_group
    count = y.shape[0] * y.shape[2] * y.shape[3]
    total = y.sum(dim=(0, 2, 3))
    if mesh.space_size == 1:
        n = div = count * mesh.world_size
        mean = all_reduce(total, group=group) / n
    else:
        parts = [y.new_full((1,), count // _COUNT_SPLIT), y.new_full((1,), count % _COUNT_SPLIT)]
        tot = all_reduce(torch.cat([total, *parts]), group=group)
        n = tot[-2].detach().double() * _COUNT_SPLIT + tot[-1].detach().double()
        div = n.to(y.dtype)
        mean = tot[:-2] / div
    var = all_reduce(((y - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3)), group=group) / div
    return mean, var, n


def conv_bn_leaky(p: Params, s: State, x: torch.Tensor, stride: int = 1,
                  training: bool = False, measure: bool = False, mesh=None):
    """Bias-less conv + BatchNorm + LeakyReLU(0.1) (the JAX
    ``conv_bn_leaky``).  The conv's result is rounded to x's dtype, then the
    BN math runs in fp32 whatever that dtype is.  Train mode normalizes with
    the batch mean and biased variance and returns running statistics
    updated as new = 0.9 * old + 0.1 * batch, with the unbiased variance;
    ``measure`` (BN re-estimation) stores the batch mean and biased variance
    themselves.  Written out as the reference writes it: with
    ``F.batch_norm`` instead, the CPU test fixtures' float32 training steps
    sat further from a float64 evaluation of the reference than its own
    float32 steps do.

    ``mesh`` (a ``(data, space)`` mesh, or None): over several ranks
    (``mesh.bn_group``) the batch statistics are those of the global batch,
    as the reference's ``jnp.mean`` / ``jnp.var`` over a sharded batch are:
    two passes, each summed over this rank's shard and all-reduced with an
    autograd-aware collective, so the backward reaches every rank's
    activations.  Under ``space`` > 1, ``x`` is this rank's stripe of rows,
    a 3x3 conv reads its halo from the neighbouring stripes, and the
    statistics cover each stripe's own rows.  Returns (y in x's dtype, new
    state)."""
    y = _conv(x, p["w"], stride, mesh).float()
    if training:
        if mesh is None or mesh.bn_group is None:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            n = y.shape[0] * y.shape[2] * y.shape[3]
        else:
            mean, var, n = _global_mean_var(y, mesh)
        if isinstance(n, int):
            unbias = n / max(n - 1, 1)
        else:
            unbias = (n / (n - 1).clamp(min=1)).to(var.dtype)
        m = 1.0 if measure else BN_MOMENTUM
        batch_var = var.detach() if measure else var.detach() * unbias
        new_s = {"mean": (1 - m) * s["mean"] + m * mean.detach(),
                 "var": (1 - m) * s["var"] + m * batch_var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + BN_EPS) * p["bn"]["scale"]
    y = (y - mean[:, None, None]) * inv[:, None, None] + p["bn"]["bias"][:, None, None]
    return F.leaky_relu(y, LEAKY_SLOPE).to(x.dtype), new_s


def apply_backbone(params: Params, state: State, x: torch.Tensor,
                   training: bool = False, measure: bool = False, mesh=None):
    """Darknet-53 on an NCHW batch (or this rank's stripe of its rows under
    a ``space`` mesh); returns the route tensors (c3, c4, c5) at strides 8,
    16, 32 and the new backbone state."""
    new_state: State = {}
    routes: List[torch.Tensor] = []
    cbl = functools.partial(conv_bn_leaky, training=training, measure=measure, mesh=mesh)
    y, new_state["stem"] = cbl(params["stem"], state["stem"], x, 1)
    for i in range(_num_stages(params)):
        sp, ss = params[f"stage{i}"], state[f"stage{i}"]
        ns: State = {}
        y, ns["down"] = cbl(sp["down"], ss["down"], y, 2)
        for b in range(_stage_blocks(sp)):
            rp, rs = sp[f"res{b}"], ss[f"res{b}"]
            t, s1 = cbl(rp["conv1"], rs["conv1"], y, 1)
            t, s2 = cbl(rp["conv2"], rs["conv2"], t, 1)
            y = y + t
            ns[f"res{b}"] = {"conv1": s1, "conv2": s2}
        new_state[f"stage{i}"] = ns
        if i >= 2:
            routes.append(y)
    return tuple(routes), new_state


def apply_head(params: Params, state: State, x: torch.Tensor,
               training: bool = False, measure: bool = False, mesh=None):
    """Detection head; returns (raw det NCHW, the 5th conv's output, new
    state).  The detection conv adds its bias after its result is rounded
    to x's dtype, as the reference does."""
    new_state: State = {}
    y = x
    for i in range(6):
        y, new_state[f"conv{i}"] = conv_bn_leaky(params[f"conv{i}"], state[f"conv{i}"],
                                                 y, 1, training, measure, mesh)
        if i == 4:
            branch = y
    det = _conv(y, params["det"]["w"], 1) + params["det"]["b"][:, None, None]
    return det.to(x.dtype), branch, new_state


def apply_yolonet(params: Params, state: State, x: torch.Tensor,
                  training: bool = False, measure: bool = False, mesh=None):
    """Full forward (the JAX ``apply_yolonet``): an NHWC image batch in the
    params' compute dtype -> the three raw heads, coarse first, each
    [B, H/s, W/s, 3*(5+C)] NHWC, and the new BN state.  An fp32 forward runs
    with TF32 off (a caller that also runs the backward keeps it off around
    both, as ``train/step.py`` does).  ``mesh``: a ``(data, space)`` mesh,
    whose ranks share train-mode BN over the global batch
    (:func:`conv_bn_leaky`); under ``space`` > 1, ``x`` is this rank's
    stripe of the images' rows and so are the heads
    (``parallel/halo.py::gather_rows`` assembles them)."""
    mode = dict(training=training, measure=measure, mesh=mesh)
    with full_fp32():
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        new_state: State = {}
        (c3, c4, c5), new_state["backbone"] = apply_backbone(
            params["backbone"], state["backbone"], y, **mode)
        det0, br0, new_state["head0"] = apply_head(params["head0"], state["head0"], c5,
                                                   **mode)
        y, s_up0 = conv_bn_leaky(params["up0"]["conv"], state["up0"]["conv"], br0, 1,
                                 **mode)
        new_state["up0"] = {"conv": s_up0}
        y = torch.cat([_upsample_nchw(y), c4], dim=1)
        det1, br1, new_state["head1"] = apply_head(params["head1"], state["head1"], y,
                                                   **mode)
        y, s_up1 = conv_bn_leaky(params["up1"]["conv"], state["up1"]["conv"], br1, 1,
                                 **mode)
        new_state["up1"] = {"conv": s_up1}
        y = torch.cat([_upsample_nchw(y), c3], dim=1)
        det2, _, new_state["head2"] = apply_head(params["head2"], state["head2"], y,
                                                 **mode)
    return tuple(d.permute(0, 2, 3, 1) for d in (det0, det1, det2)), new_state


def recalibrate_bn(params: Params, state: State, batches, mesh=None) -> State:
    """BN re-estimation (the JAX ``recalibrate_bn``): the running statistics
    replaced by the mean of the per-batch statistics of ``batches`` (one
    NHWC tensor or an iterable of equally shaped ones), each measured in a
    train-mode forward with momentum 1 and the biased variance.  The
    measuring mode is an argument of the forward, not a global, so calls
    never see one another's mode, and an error leaves nothing changed.
    ``mesh``: each rank passes its shard (its stripe of
    it under ``space`` > 1) and the statistics are the global batch's."""
    if isinstance(batches, torch.Tensor):
        batches = [batches]
    batches = list(batches)
    shapes = {tuple(x.shape) for x in batches}
    if len(shapes) != 1:
        raise ValueError(f"recalibrate_bn batches must share one shape, got {shapes}")
    with torch.no_grad():
        states = [apply_yolonet(params, state, x, training=True, measure=True,
                                mesh=mesh)[1]
                  for x in batches]
    if len(states) == 1:
        return states[0]
    return map_tree(lambda *xs: sum(xs) / len(xs), *states)


class _TreeModule(nn.Module):
    """A nested dict of tensors held as a module tree: each leaf a parameter
    (``as_params``) or a buffer under its key."""

    def __init__(self, tree, as_params: bool):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _TreeModule(v, as_params))
            elif as_params:
                self.register_parameter(k, nn.Parameter(v.detach().clone()))
            else:
                self.register_buffer(k, v.detach().clone())

    def tree(self):
        return {k: (getattr(self, k).tree() if isinstance(getattr(self, k), _TreeModule)
                    else getattr(self, k)) for k in self._keys}


class YoloNet(nn.Module):
    """Training-form YOLOv3: every conv weight, BN scale and bias and
    detection bias an ``nn.Parameter``, every BN running mean and variance a
    buffer, laid out as the ``{params, state}`` trees (``param_tree`` /
    ``state_tree`` return them, ``trees`` detached copies, the constructor
    takes them).  ``forward(x)`` takes an NHWC batch in the params' dtype
    and returns the three NHWC raw heads; in train mode it normalizes with
    batch statistics and updates the buffers, in eval mode it uses them."""

    def __init__(self, params: Params, state: State):
        super().__init__()
        self.params = _TreeModule(params, as_params=True)
        self.stats = _TreeModule(state, as_params=False)

    def param_tree(self) -> Params:
        return self.params.tree()

    def state_tree(self) -> State:
        return self.stats.tree()

    def trees(self) -> Tuple[Params, State]:
        detach = lambda t: t.detach().clone()               # noqa: E731
        return map_tree(detach, self.param_tree()), map_tree(detach, self.state_tree())

    def forward(self, x: torch.Tensor):
        raws, new_state = apply_yolonet(self.param_tree(), self.state_tree(), x,
                                        training=self.training)
        if self.training:
            with torch.no_grad():
                map_tree(lambda buf, new: buf.copy_(new), self.state_tree(), new_state)
        return raws


# ---------------------------------------------------------------------------
# Folded inference forward
# ---------------------------------------------------------------------------

class _ConvBias(nn.Module):
    """Conv + bias + activation (``leaky``, ``mish`` or ``linear``) on NCHW
    channels_last activations, from an HWIO weight; the output keeps the
    input's dtype.

    In bf16 (the stem and the stride-2 downs) conv, bias and activation
    round once, as the reference's ``_conv_bias_leaky`` does: on a card on
    the hand-written kernel (:func:`~yolo_v3_tpu_torch.ops.conv_down.
    conv_down`, which raises for a conv it does not take), and on the CPU
    or with ``plain=True`` on its plain version, cuDNN convs in fp32 over
    chunks of input channels, bias and activation in fp32, one cast."""

    def __init__(self, p: Params, stride: int = 1, act: str = "leaky"):
        super().__init__()
        w = p["w"]
        self.register_buffer("weight", w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last))
        self.register_buffer("bias", p["b"].clone())
        self.stride = stride
        self.pad = (w.shape[0] - 1) // 2
        self.act = act

    def forward(self, x, mesh=None, plain=False):
        """``mesh``: under ``space`` > 1, ``x`` is a stripe of rows and a
        3x3 conv reads its halo from the neighbouring stripes."""
        pad = self.pad
        if pad and _space_sharded(mesh):
            x, pad = _halo(x, self.stride, mesh), (0, pad)
        if x.dtype != torch.bfloat16:
            y = F.conv2d(x, self.weight, self.bias, self.stride, pad)
            return CD.activate_(y, self.act)
        if plain or x.device.type == "cpu":
            return CD.conv_down_ref(x, self.weight, self.bias, self.stride, pad, self.act)
        x = x.contiguous(memory_format=torch.channels_last)
        return CD.conv_down(x, self.weight, self.bias, self.stride, pad, self.act)


class _ResBlock(nn.Module):
    """Residual block weights in the kernel's layout: w1 [C, Cmid], w2 HWIO."""

    def __init__(self, p: Params):
        super().__init__()
        w1 = p["conv1"]["w"]
        self.register_buffer("w1", w1.reshape(w1.shape[2], w1.shape[3]).contiguous())
        self.register_buffer("b1", p["conv1"]["b"].contiguous())
        self.register_buffer("w2", p["conv2"]["w"].contiguous())
        self.register_buffer("b2", p["conv2"]["b"].contiguous())

    def forward(self, x, res_block, mesh=None):
        """``mesh``: under ``space`` > 1 the block runs on the stripe
        extended by a row of each neighbouring stripe (none at the image's
        real top and bottom), and its output is cut back to the stripe: the
        kernel's zero padding of conv1's output then falls on rows the cut
        drops, or on the image's real edge."""
        top = bottom = 0
        if _space_sharded(mesh):
            above, below = edge_rows(x, mesh, 1, 1)
            top, bottom = int(mesh.space_index > 0), int(mesh.space_index < mesh.space_size - 1)
            x = torch.cat([above[:, :, :top], x, below[:, :, :bottom]], dim=2)
        y = x.permute(0, 2, 3, 1)                   # NHWC view, no copy
        if not y.is_contiguous():
            y = y.contiguous()
        out = res_block(y, self.w1, self.b1, self.w2, self.b2)
        if top or bottom:
            out = out.narrow(1, top, out.shape[1] - top - bottom)
        return out.permute(0, 3, 1, 2)              # NCHW, channels_last


class _Head(nn.Module):
    def __init__(self, hp: Params):
        super().__init__()
        self.convs = nn.ModuleList(_ConvBias(hp[f"conv{i}"]) for i in range(6))
        self.det = _ConvBias(hp["det"], act="linear")

    def forward(self, x, mesh=None):
        for i, conv in enumerate(self.convs):
            x = conv(x, mesh)
            if i == 4:
                branch = x
        return self.det(x), branch


class _P2dConv(nn.Module):
    """A stride-1 1x1 or 3x3 conv + bias (+ LeakyReLU) on the padded-2D
    layout, from an HWIO weight: the bf16 kernels with scale 1 and a float32
    bias, bf16 out."""

    def __init__(self, p: Params, leaky: bool = True):
        super().__init__()
        w = p["w"]
        self.taps = w.shape[0] * w.shape[1]
        if self.taps == 1:
            w = w.reshape(w.shape[2], w.shape[3])
        self.register_buffer("weight", w.contiguous())
        self.register_buffer("scale", torch.ones(w.shape[-1], dtype=torch.float32,
                                                 device=w.device))
        self.register_buffer("bias", p["b"].float().contiguous())
        self.leaky = leaky
        # (kernel wrapper, plain version)
        self.fns = ((FC.conv3x3_p2d, FC.conv3x3_p2d_ref) if self.taps == 9
                    else (FC.conv1x1_p2d, FC.conv1x1_p2d_ref))

    def forward(self, x2d, hp, wp, plain, mesh=None):
        """``mesh``: under ``space`` > 1 a 3x3 first writes the rows of the
        neighbouring stripes into the layout's top and bottom border rows
        (:func:`p2d_halo_rows`); the epilogue zeroes them in the output."""
        if self.taps == 9:
            x2d = p2d_halo_rows(x2d, hp, wp, mesh)
        return self.fns[plain](x2d, self.weight, self.scale, self.bias, hp, wp,
                               leaky=self.leaky, out_dtype=torch.bfloat16)


class _P2dHead(nn.Module):
    """A head on the padded-2D layout (the int8 ``_QHead``'s structure)."""

    def __init__(self, hp: Params):
        super().__init__()
        self.convs = nn.ModuleList(_P2dConv(hp[f"conv{i}"]) for i in range(6))
        self.det = _P2dConv(hp["det"], leaky=False)

    def forward(self, x2d, hp, wp, plain, mesh=None):
        for i, conv in enumerate(self.convs):
            x2d = conv(x2d, hp, wp, plain, mesh)
            if i == 4:
                branch = x2d
        return self.det(x2d, hp, wp, plain), branch


class YoloNetFolded(nn.Module):
    """Inference YOLOv3 on BN-folded params (see :func:`fold_batchnorm`),
    the port of the JAX ``apply_yolonet_folded`` on non-s2d params.

    ``forward(x)`` takes an NHWC image batch in the params' dtype and
    returns the three raw heads, coarse first, each
    [B, H/s, W/s, 3*(5+C)] NHWC.  The residual blocks, and in bf16 the head
    and upsample convs, run on the kernel wrappers, or on their plain
    versions with ``plain=True``.  An fp32 forward runs with TF32 off.

    ``forward(x, mesh=...)`` with a ``(data, space)`` mesh of ``space`` > 1
    takes this rank's stripe of the images' rows (``parallel/mesh.py::
    stripe``) and returns the whole heads on every rank of its space group:
    each 3x3 conv reads its halo rows from the neighbouring stripes, and the
    heads are gathered at the end (``parallel/halo.py``).
    """

    def __init__(self, params: Params):
        super().__init__()
        bk = params["backbone"]
        self.dtype = bk["stem"]["w"].dtype
        self.stem = _ConvBias(bk["stem"])
        self.downs = nn.ModuleList()
        self.stages = nn.ModuleList()
        for i in range(_num_stages(bk)):
            sp = bk[f"stage{i}"]
            self.downs.append(_ConvBias(sp["down"], stride=2))
            self.stages.append(nn.ModuleList(
                _ResBlock(sp[f"res{b}"]) for b in range(_stage_blocks(sp))))
        # bf16: the heads on the padded-2D kernels, which have no fp32 mode
        head, up = ((_P2dHead, _P2dConv) if self.dtype == torch.bfloat16
                    else (_Head, _ConvBias))
        self.head0 = head(params["head0"])
        self.up0 = up(params["up0"]["conv"])
        self.head1 = head(params["head1"])
        self.up1 = up(params["up1"]["conv"])
        self.head2 = head(params["head2"])

    @property
    def num_res_blocks(self) -> int:
        return sum(len(s) for s in self.stages)

    def forward(self, x: torch.Tensor, plain: bool = False, mesh=None):
        exact = full_fp32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with exact:
            res_block = fused_res_block_ref if plain else fused_res_block
            y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            y = self.stem(y, mesh, plain)
            routes: List[torch.Tensor] = []
            for i, (down, blocks) in enumerate(zip(self.downs, self.stages)):
                y = down(y, mesh, plain)
                for blk in blocks:
                    y = blk(y, res_block, mesh)
                if i >= 2:
                    routes.append(y)
            if self.dtype == torch.bfloat16:
                heads = self._p2d_heads(routes, plain, mesh)
            else:
                c3, c4, c5 = routes
                det0, br0 = self.head0(c5, mesh)
                y = torch.cat([_upsample_nchw(self.up0(br0)), c4], dim=1)
                det1, br1 = self.head1(y, mesh)
                y = torch.cat([_upsample_nchw(self.up1(br1)), c3], dim=1)
                det2, _ = self.head2(y, mesh)
                heads = tuple(d.permute(0, 2, 3, 1) for d in (det0, det1, det2))
            if _space_sharded(mesh):
                heads = tuple(gather_rows(h, mesh) for h in heads)
            return heads

    def _p2d_heads(self, routes, plain, mesh):
        """The heads and upsample convs on the padded-2D layout: each route
        packed once, the up conv's output unpacked, upsampled, concatenated
        with the next route and packed again."""
        c3, c4, c5 = (r.permute(0, 2, 3, 1) for r in routes)     # NHWC views

        def geometry(t):
            _, hp, wp = FC.p2d_geometry(*t.shape[:3])
            return hp, wp

        def up_concat(up, br2d, small, route):
            u = FC.unpack_p2d(up(br2d, *geometry(small), plain), *small.shape[:3])
            return FC.pack_p2d(torch.cat([upsample2x_nearest(u), route], dim=-1))

        det0, br0 = self.head0(FC.pack_p2d(c5), *geometry(c5), plain, mesh)
        det1, br1 = self.head1(up_concat(self.up0, br0, c5, c4), *geometry(c4), plain, mesh)
        det2, _ = self.head2(up_concat(self.up1, br1, c4, c3), *geometry(c3), plain, mesh)
        return tuple(FC.unpack_p2d(d, *g.shape[:3]).contiguous()
                     for d, g in ((det0, c5), (det1, c4), (det2, c3)))


def _upsample_nchw(x: torch.Tensor) -> torch.Tensor:
    return upsample2x_nearest(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Space-to-depth weight folds (the JAX ``darknet.py`` s2d section).  The stem,
# stage 0 and stage 1's downsample are re-expressed in a 2x2 space-to-depth
# domain with exactly remapped weights: a permutation of the same dot
# products.  The int8 serving tree is built from these folds.  Like the JAX
# package's, the folds are numpy: they run once, on the host.
# ---------------------------------------------------------------------------

def _np32(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
    return np.asarray(w, np.float32)


def _s2d_1x1_weights(w):
    """[1,1,cin,cout] -> [1,1,4cin,4cout] block-diagonal: a 1x1 conv acts on
    each of the 4 spatial sub-positions independently."""
    w = _np32(w).reshape(w.shape[2], w.shape[3])
    cin, cout = w.shape
    out = np.zeros((1, 1, 4 * cin, 4 * cout), np.float32)
    for k in range(4):
        out[0, 0, k * cin:(k + 1) * cin, k * cout:(k + 1) * cout] = w
    return out


def _s2d_3x3_s1_weights(w):
    """stride-1 3x3 conv, s2d input and output: [3,3,cin,cout] ->
    [3,3,4cin,4cout], block-space padding (1,1)."""
    w = _np32(w)
    cin, cout = w.shape[2], w.shape[3]
    out = np.zeros((3, 3, 4 * cin, 4 * cout), np.float32)
    for dy in range(2):
        for dx in range(2):
            for u in range(3):
                for v in range(3):
                    t, s = dy + u - 1, dx + v - 1
                    P, by = t // 2 + 1, t % 2
                    Q, bx = s // 2 + 1, s % 2
                    ci = (by * 2 + bx) * cin
                    co = (dy * 2 + dx) * cout
                    out[P, Q, ci:ci + cin, co:co + cout] = w[u, v]
    return out


def _s2d_3x3_s2_weights(w):
    """stride-2 3x3 conv, s2d input and s2d output: [3,3,cin,cout] ->
    [3,3,4cin,4cout] at block stride 2, block-space padding (1,1)."""
    w = _np32(w)
    cin, cout = w.shape[2], w.shape[3]
    out = np.zeros((3, 3, 4 * cin, 4 * cout), np.float32)
    for dy in range(2):
        for dx in range(2):
            for u in range(3):
                for v in range(3):
                    t, s = 2 * dy + u - 1, 2 * dx + v - 1
                    P, by = t // 2 + 1, t % 2
                    Q, bx = s // 2 + 1, s % 2
                    ci = (by * 2 + bx) * cin
                    co = (dy * 2 + dx) * cout
                    out[P, Q, ci:ci + cin, co:co + cout] = w[u, v]
    return out


def _s2d_3x3_s2_exit_weights(w):
    """stride-2 3x3 conv, s2d input, native output: [3,3,cin,cout] ->
    [2,2,4cin,cout], block-space padding (1,0)."""
    w = _np32(w)
    cin, cout = w.shape[2], w.shape[3]
    out = np.zeros((2, 2, 4 * cin, cout), np.float32)
    for u in range(3):
        for v in range(3):
            t, s = u - 1, v - 1
            P, by = t // 2 + 1, t % 2
            Q, bx = s // 2 + 1, s % 2
            ci = (by * 2 + bx) * cin
            out[P, Q, ci:ci + cin, :] = w[u, v]
    return out


def _stem4_weights(stem_w, stem_b):
    """The stem in the 4x4 space-to-depth domain: [3,3,cin,c1] ->
    [2,2,16cin,16c1] VALID conv over the (1,3)x(1,3)-padded, 4x4-block
    image; returns (weights, bias tiled 16 times)."""
    stem_w = _np32(stem_w)
    stem_b = _np32(stem_b)
    cin, c1 = stem_w.shape[2], stem_w.shape[3]
    w4 = np.zeros((2, 2, 16 * cin, 16 * c1), np.float32)
    for dy in range(4):
        for dx in range(4):
            co = (dy * 4 + dx) * c1
            for u in range(3):
                for v in range(3):
                    t, s = dy + u, dx + v
                    ci = ((t % 4) * 4 + (s % 4)) * cin
                    w4[t // 4, s // 4, ci:ci + cin, co:co + c1] = stem_w[u, v]
    return w4, np.tile(stem_b, 16)


def _down0_4_weights(w):
    """down0 (3x3/2) reading the 4x4-block stem output directly:
    [3,3,cin,cout] -> [2,2,16cin,4cout], stride 1, block-space padding
    (1,0); output in the 2x2-block layout."""
    w = _np32(w)
    cin, cout = w.shape[2], w.shape[3]
    out = np.zeros((2, 2, 16 * cin, 4 * cout), np.float32)
    for by in range(2):
        for bx in range(2):
            co = (by * 2 + bx) * cout
            for u in range(3):
                for v in range(3):
                    t = 2 * by + u - 1
                    s = 2 * bx + v - 1
                    kI, dy = t // 4 + 1, t % 4
                    kJ, dx = s // 4 + 1, s % 4
                    ci = (dy * 4 + dx) * cin
                    out[kI, kJ, ci:ci + cin, co:co + cout] = w[u, v]
    return out


def _s2d_stem_weights(w):
    """stem 3x3/s1 conv on the (1,3)x(1,3)-padded 2x2-block image:
    [3,3,cin,c1] -> [3,3,4cin,4c1] VALID conv over blocks."""
    w = _np32(w)
    cin, c1 = w.shape[2], w.shape[3]
    out = np.zeros((3, 3, 4 * cin, 4 * c1), np.float32)
    for dy in range(2):
        for dx in range(2):
            for u in range(3):
                for v in range(3):
                    t, s = dy + u - 1, dx + v - 1
                    P, by = (t + 1) // 2, (t + 1) % 2
                    Q, bx = (s + 1) // 2, (s + 1) % 2
                    ci = (by * 2 + bx) * cin
                    co = (dy * 2 + dx) * c1
                    out[P, Q, ci:ci + cin, co:co + c1] = w[u, v]
    return out


def fold_space_to_depth(folded: Params) -> Params:
    """Add 's2d' remapped weights covering the stem, all of stage 0 and
    stage 1's downsample (the JAX ``fold_space_to_depth``); tensors keep the
    stem weight's dtype and device."""
    bk = folded["backbone"]
    s0, s1 = bk["stage0"], bk["stage1"]
    like = bk["stem"]["w"]

    def block(w, b):
        return {"w": torch.from_numpy(w).to(like.device, like.dtype),
                "b": torch.from_numpy(np.ascontiguousarray(b)).to(like.device, like.dtype)}

    out = dict(folded)
    out["s2d"] = {
        "stem": block(_s2d_stem_weights(bk["stem"]["w"]),
                      np.tile(_np32(bk["stem"]["b"]), 4)),
        "down0": block(_s2d_3x3_s2_weights(s0["down"]["w"]),
                       np.tile(_np32(s0["down"]["b"]), 4)),
        "res0_1": block(_s2d_1x1_weights(s0["res0"]["conv1"]["w"]),
                        np.tile(_np32(s0["res0"]["conv1"]["b"]), 4)),
        "res0_2": block(_s2d_3x3_s1_weights(s0["res0"]["conv2"]["w"]),
                        np.tile(_np32(s0["res0"]["conv2"]["b"]), 4)),
        "down1": block(_s2d_3x3_s2_exit_weights(s1["down"]["w"]),
                       _np32(s1["down"]["b"])),
    }
    return out


def _space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B, 2H, 2W, C] -> [B, H, W, 4C] with (by, bx, c) channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """[B, 4H, 4W, C] -> [B, H, W, 16C] with (by, bx, c) channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 4, w // 4, 16 * c)


# ---------------------------------------------------------------------------
# Canonical conv ordering — the contract the darknet weight codec relies on.
# ---------------------------------------------------------------------------

def conv_layer_paths(
    num_stages: Optional[int] = None,
    blocks: Tuple[int, ...] = DARKNET53_BLOCKS,
) -> List[Tuple[str, ...]]:
    """Paths of all conv blocks in darknet cfg order: backbone, head0, up0,
    head1, up1, head2 (the JAX ``conv_layer_paths``)."""
    if num_stages is None:
        num_stages = len(blocks)
    paths: List[Tuple[str, ...]] = [("backbone", "stem")]
    for i in range(num_stages):
        paths.append(("backbone", f"stage{i}", "down"))
        for b in range(blocks[i]):
            paths.append(("backbone", f"stage{i}", f"res{b}", "conv1"))
            paths.append(("backbone", f"stage{i}", f"res{b}", "conv2"))
    for h, up in (("head0", "up0"), ("head1", "up1"), ("head2", None)):
        for i in range(6):
            paths.append((h, f"conv{i}"))
        paths.append((h, "det"))
        if up is not None:
            paths.append((up, "conv"))
    return paths


def backbone_conv_paths() -> List[Tuple[str, ...]]:
    """The backbone's 52 convs, the darknet53.conv.74 load target (the JAX
    ``backbone_conv_paths``)."""
    return [p for p in conv_layer_paths() if p[0] == "backbone"]
