"""Seeded YOLOv3 weights and BN statistics, made on the device.

The trees have the port's layout (nested dicts, HWIO conv weights, ``bn``
scale and bias, ``state`` mean and var), which is what both the program and
the references take.  All conv weights come from one ``torch.rand`` call on
a ``torch.Generator`` on the device, scaled per conv to Kaiming-uniform
fan-in bounds (torch ``Conv2d``'s default); the BN scales and biases from
two more, spread: scale 1 + U[0, 1), bias 0.1 N(0, 1).  The BN statistics
are measured on seeded scenes (BN re-estimation, in a plain float32
forward), the variance taken ``VAR_SCALE`` times over.  Statistics drawn at
random leave every activation dominated by its mean: the heads of two
scenes differ by about 2% of their size, so no check could tell one scene
from another.  Exactly measured ones put the random network on the chaotic
side: rounding the convs' operands to bf16 moves its heads by 13%.  At 1.3
times the measured variance the heads of two scenes differ by about a
quarter of their size and bf16 rounding moves them by about 1.5% (at 416,
on the CPU, seeds 5 and 77).  The detection convs' biases are uniform
within the same bound as their weights, the objectness channels' offset so
that on the measuring scenes ``CANDIDATES`` cell-anchors a scene score above
0.5: a busy scene, and the same postprocess work for every seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.counts import conv_layers

VAR_SCALE = 1.3
CANDIDATES = 30


def _path(tree, path: str):
    node = tree
    for key in path.split("/"):
        node = node.setdefault(key, {})
    return node


def _param_path(name: str) -> str:
    """The port's tree path of a conv named as ``counts.conv_layers`` names it."""
    if name == "stem" or name.startswith("stage"):
        return "backbone/" + name
    if name in ("up0", "up1"):
        return name + "/conv"
    return name


def make(cfg: Dict, seed: int, device, bn_images) -> Tuple[Dict, Dict]:
    """(params, state) float32 trees on ``device`` from ``seed``, with BN
    statistics measured on ``bn_images`` (HWC uint8 scenes, letterboxed)."""
    from portbench.reference import letterbox, yolov3

    layers = conv_layers(cfg["blocks"], cfg["classes"], cfg["input_size"])
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [l["k"] ** 2 * l["cin"] * l["cout"] for l in layers]
    dets = [l for l in layers if l["role"] == "det"]
    n_w = sum(sizes)
    n_b = sum(l["cout"] for l in dets)
    u = torch.rand(n_w + n_b, generator=gen, device=device) * 2 - 1
    bn_layers = [l for l in layers if l["role"] != "det"]
    n_bn = sum(l["cout"] for l in bn_layers)
    scale = 1.0 + torch.rand(n_bn, generator=gen, device=device)
    bias = 0.1 * torch.randn(n_bn, generator=gen, device=device)

    params: Dict = {}
    state: Dict = {}
    at = at_b = at_bn = 0
    for l, n in zip(layers, sizes):
        bound = math.sqrt(1.0 / (l["cin"] * l["k"] ** 2))
        w = (u[at:at + n] * bound).reshape(l["k"], l["k"], l["cin"], l["cout"])
        at += n
        p = _path(params, _param_path(l["name"]))
        p["w"] = w
        c = l["cout"]
        if l["role"] == "det":
            p["b"] = u[n_w + at_b:n_w + at_b + c] * bound
            at_b += c
            continue
        sl = slice(at_bn, at_bn + c)
        at_bn += c
        p["bn"] = {"scale": scale[sl], "bias": bias[sl]}
        _path(state, _param_path(l["name"]))
    x = letterbox.letterbox_batch(bn_images, cfg["input_size"], device).float()
    with torch.no_grad():
        yolov3.heads_float(params, state, x, cfg["blocks"], measure=True)
        _scale_var(state)
        heads = yolov3.heads_float(params, state, x, cfg["blocks"])
    shift = _objectness_shift(heads, CANDIDATES * len(bn_images))
    for name in ("head0", "head1", "head2"):
        b = params[name]["det"]["b"].reshape(3, -1)
        b[:, 4] += shift
    return params, state


def _scale_var(state):
    if "var" in state:
        state["var"] = state["var"] * VAR_SCALE
        return
    for v in state.values():
        _scale_var(v)


def _objectness_shift(heads, k: int) -> float:
    """The offset of the objectness logits that leaves ``k`` cell-anchors of
    ``heads`` with sigmoid(obj) x sigmoid(best class) above 0.5."""
    margins = []
    for h in heads:
        r = h.reshape(h.shape[0], -1, h.shape[-1] // 3)
        need = 0.5 / torch.sigmoid(r[..., 5:].amax(-1))
        margin = r[..., 4] - torch.logit(need.clamp(max=1 - 1e-6))
        margins.append(torch.where(need < 1, margin, torch.full_like(margin, -1e9)).reshape(-1))
    top = torch.topk(torch.cat(margins), k + 1).values
    return float(-(top[k - 1] + top[k]) / 2)


def leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every leaf of a tree, in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]
