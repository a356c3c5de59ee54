"""Seeded YOLOv4 weights and BN statistics, made on the device, as
``weights.py`` makes YOLOv3's.

The trees have the port's YOLOv4 layout (the tree paths of
``counts_yolov4.conv_layers``): all conv weights from one ``torch.rand``
call on a ``torch.Generator`` on the device, Kaiming-uniform fan-in bounds;
BN scale 1 + U[0, 1), bias 0.1 N(0, 1); detection biases uniform within
their weights' bound.  The BN statistics are measured on seeded scenes in
the plain float32 forward (``reference/yolov4.py``), the variance taken
``VAR_SCALE`` times over, and the objectness biases offset so that
``weights.CANDIDATES`` cell-anchors a measuring scene score above 0.5.

``VAR_SCALE`` follows ``weights.py``'s criterion, measured again for this
Mish network on an H100 at 608 (``control_yolov4.py --var-scales``,
PERF.md): at 1.3 the heads of two scenes differ by 29-32% of their size and
the program's bf16 rounding moves them by 3.0-3.7%; at 1.0 the network is
chaotic (bf16 moves the heads by their whole size), at 2.0 the scenes'
heads differ by 1%.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.counts_yolov4 import conv_layers
from portbench.weights import CANDIDATES, _objectness_shift, _path

VAR_SCALE = 1.3


def _scale_var(state, k: float):
    if "var" in state:
        state["var"] = state["var"] * k
        return
    for v in state.values():
        _scale_var(v, k)


def make(cfg: Dict, seed: int, device, bn_images, var_scale: float = VAR_SCALE
         ) -> Tuple[Dict, Dict]:
    """(params, state) float32 trees on ``device`` from ``seed``, with BN
    statistics measured on ``bn_images`` (HWC uint8 scenes, letterboxed)."""
    from portbench.reference import letterbox, yolov4

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
        p = _path(params, l["name"])
        p["w"] = (u[at:at + n] * bound).reshape(l["k"], l["k"], l["cin"], l["cout"])
        at += n
        c = l["cout"]
        if l["role"] == "det":
            p["b"] = u[n_w + at_b:n_w + at_b + c] * bound
            at_b += c
            continue
        sl = slice(at_bn, at_bn + c)
        at_bn += c
        p["bn"] = {"scale": scale[sl], "bias": bias[sl]}
        _path(state, l["name"])
    x = letterbox.letterbox_batch(bn_images, cfg["input_size"], device).float()
    with torch.no_grad():
        yolov4.heads_float(params, state, x, cfg["blocks"], measure=True)
        _scale_var(state, var_scale)
        heads = yolov4.heads_float(params, state, x, cfg["blocks"])
    shift = _objectness_shift(heads, CANDIDATES * len(bn_images))
    for name in ("head0", "head1", "head2"):
        b = params[name]["det"]["b"].reshape(3, -1)
        b[:, 4] += shift
    return params, state
