"""Plain YOLOv3 (Darknet-53 and three heads), float and int8.

Float: every conv is followed by BatchNorm with running statistics and
LeakyReLU(0.1), except the three detection convs (bias, no activation);
3x3 convs pad 1 on each side (darknet's ``pad=1``); residual blocks add;
route 1 upsamples the coarse branch by 2 (nearest) and concatenates the
stage-3 output, route 2 the stage-2 output.  Computed in float32 with TF32
off.

int8 (the serving scheme the port documents): BN folded into the convs;
weights symmetric per output channel (absmax / 127); activations per tensor,
static, at the 0.9997 quantile of |x| of every conv's output (after the add
for a residual block's second conv, of the concatenation for a route),
measured in float32 on calibration images on a subsample of at most ~4M
values in NHWC order, and for the first five convs (stem, stage-0 down and
block, whose int8 form runs in a 2x2 space-to-depth layout) in that
layout's order; the image quantized at its own quantile.  Every conv
accumulates exactly, then ``clip(round(leaky(acc * m + b) + res * s_res))``
with ``m = s_in * s_w / s_out`` and ``b = bias / s_out`` in float32;
route branches are requantized to the concatenation's scale; the
detection convs return ``acc * s_in * s_w + bias`` in bfloat16.  ``qmax``
7 gives the same scheme in 4 bits (the int8 cell's control).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import tf32

EPS = 1e-5
SLOPE = 0.1
CALIB_Q = 0.9997


def _w(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _routes_from(blocks) -> int:
    return len(blocks) - 3


# ---------------------------------------------------------------------------
# Float
# ---------------------------------------------------------------------------

def heads_float(params: Dict, state: Dict, x: torch.Tensor, blocks, measure: bool = False):
    """[B, H, W, 3] float images -> the three raw heads, coarse first, NHWC
    float32.  ``measure`` normalizes with the batch's own mean and biased
    variance and writes them into ``state`` as its statistics (BN
    re-estimation)."""
    def conv(p, y, stride):
        w = _w(p["w"].float())
        return F.conv2d(y, w, None, stride, (w.shape[2] - 1) // 2)

    def cbl(p, s, y, stride=1):
        y = conv(p, y, stride)
        if not measure:
            mean, var = s["mean"].float(), s["var"].float()
        else:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            s["var"], s["mean"] = var, mean
        inv = p["bn"]["scale"].float() / torch.sqrt(var + EPS)
        y = (y - mean[:, None, None]) * inv[:, None, None] + p["bn"]["bias"].float()[:, None, None]
        return F.leaky_relu(y, SLOPE)

    def head(name, y):
        hp, hs = params[name], state[name]
        for j in range(6):
            y = cbl(hp[f"conv{j}"], hs[f"conv{j}"], y)
            if j == 4:
                branch = y
        return conv(hp["det"], y, 1) + hp["det"]["b"].float()[:, None, None], branch

    with tf32(False):
        bk, bs = params["backbone"], state["backbone"]
        y = cbl(bk["stem"], bs["stem"], x.float().permute(0, 3, 1, 2))
        routes = []
        for i, n in enumerate(blocks):
            sp, ss = bk[f"stage{i}"], bs[f"stage{i}"]
            y = cbl(sp["down"], ss["down"], y, 2)
            for b in range(n):
                rp, rs = sp[f"res{b}"], ss[f"res{b}"]
                y = y + cbl(rp["conv2"], rs["conv2"], cbl(rp["conv1"], rs["conv1"], y))
            if i >= _routes_from(blocks):
                routes.append(y)
        c3, c4, c5 = routes
        d0, br = head("head0", c5)
        y = torch.cat([_up2(cbl(params["up0"]["conv"], state["up0"]["conv"], br)), c4], 1)
        d1, br = head("head1", y)
        y = torch.cat([_up2(cbl(params["up1"]["conv"], state["up1"]["conv"], br)), c3], 1)
        d2, _ = head("head2", y)
    return tuple(d.permute(0, 2, 3, 1).contiguous() for d in (d0, d1, d2))


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def fold(params: Dict, state: Dict) -> Dict:
    """{conv path: {"w" HWIO, "b"}} with BN folded, float32."""
    out: Dict = {}

    def walk(p, s, path):
        if "bn" in p:
            inv = p["bn"]["scale"].float() / torch.sqrt(s["var"].float() + EPS)
            out[path] = {"w": p["w"].float() * inv,
                         "b": p["bn"]["bias"].float() - s["mean"].float() * inv}
        elif "b" in p:
            out[path] = {"w": p["w"].float(), "b": p["b"].float()}
        else:
            for k in p:
                walk(p[k], s.get(k, {}), f"{path}/{k}" if path else k)

    walk(params, state, "")
    return out


def _amax(t_nhwc: torch.Tensor) -> torch.Tensor:
    a = t_nhwc.float().abs().reshape(-1)
    stride = max(a.shape[0] // (2 << 20), 1)
    return torch.quantile(a[::stride], CALIB_Q)


def _s2d(t_nhwc: torch.Tensor) -> torch.Tensor:
    b, h, w, c = t_nhwc.shape
    t = t_nhwc.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h // 2, w // 2, 4 * c)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def calibrate(folded: Dict, x: torch.Tensor, blocks) -> Dict[str, float]:
    """0.9997 quantiles of |activation| keyed by conv path ("image",
    "concat1", "concat2" besides), float32 forward with TF32 off."""
    stats: Dict[str, torch.Tensor] = {"image": _amax(x)}
    entry = {"backbone/stem", "backbone/stage0/down", "backbone/stage0/res0/conv1",
             "backbone/stage0/res0/conv2"}

    def conv(key, y, stride=1, leaky=True):
        p = folded[key]
        w = _w(p["w"])
        y = F.conv2d(y, w, p["b"], stride, (w.shape[2] - 1) // 2)
        return F.leaky_relu(y, SLOPE) if leaky else y

    def record(key, y):
        stats[key] = _amax(_s2d(_nhwc(y)) if key in entry else _nhwc(y))
        return y

    with tf32(False), torch.no_grad():
        y = record("backbone/stem", conv("backbone/stem", x.float().permute(0, 3, 1, 2)))
        routes = []
        for i, n in enumerate(blocks):
            pre = f"backbone/stage{i}"
            y = record(f"{pre}/down", conv(f"{pre}/down", y, 2))
            for b in range(n):
                r = record(f"{pre}/res{b}/conv1", conv(f"{pre}/res{b}/conv1", y))
                y = record(f"{pre}/res{b}/conv2", y + conv(f"{pre}/res{b}/conv2", r))
            if i >= _routes_from(blocks):
                routes.append(y)
        c3, c4, c5 = routes

        def head(name, y):
            for j in range(6):
                y = record(f"{name}/conv{j}", conv(f"{name}/conv{j}", y))
                if j == 4:
                    branch = y
            return branch

        br = head("head0", c5)
        y = record("concat1", torch.cat([_up2(record("up0/conv", conv("up0/conv", br))), c4], 1))
        br = head("head1", y)
        y = record("concat2", torch.cat([_up2(record("up1/conv", conv("up1/conv", br))), c3], 1))
        head("head2", y)
    return {k: float(v) for k, v in stats.items()}


def _scale(stat: float, qmax: int) -> float:
    return float(max(np.float32(stat) / np.float32(qmax), 1e-8))


class Int8Net:
    """The quantized network of ``folded`` at the calibration ``stats``."""

    def __init__(self, folded: Dict, stats: Dict[str, float], blocks, qmax: int = 127):
        self.blocks = blocks
        self.qmax = qmax
        self.s = {k: _scale(v, qmax) for k, v in stats.items()}
        self.q: Dict = {}
        for key, p in folded.items():
            w = p["w"].float()
            absmax = w.abs().amax(dim=(0, 1, 2))
            sw = torch.clamp(absmax / qmax, min=1e-12)
            self.q[key] = {"w": torch.clamp(torch.round(w / sw), -qmax, qmax),
                           "sw": sw, "b": p["b"].float()}

    def _conv(self, key, x, s_in, s_out, stride=1, residual=None, res_scale=1.0):
        p = self.q[key]
        w = _w(p["w"])
        acc = F.conv2d(x.double(), w.double(), None, stride, (w.shape[2] - 1) // 2).round()
        if s_out is None:
            y = acc.float() * (p["sw"] * s_in)[:, None, None] + p["b"][:, None, None]
            return y.to(torch.bfloat16)
        m = p["sw"] * s_in / s_out
        y = acc.float() * m[:, None, None] + (p["b"] / s_out)[:, None, None]
        y = torch.where(y > 0, y, SLOPE * y)
        if residual is not None:
            y = y + residual * res_scale
        return torch.clamp(torch.round(y), -self.qmax, self.qmax)

    def _requant(self, codes, s_from, s_to):
        return torch.clamp(torch.round(codes * (s_from / s_to)), -self.qmax, self.qmax)

    def heads(self, x: torch.Tensor):
        """[B, H, W, 3] float images -> three bf16 NHWC raw heads."""
        s = self.s
        with tf32(False), torch.no_grad():
            s_img = torch.full((), s["image"], dtype=torch.float32, device=x.device)
            y = torch.clamp(torch.round(x.float() / s_img), -self.qmax, self.qmax)
            y = y.permute(0, 3, 1, 2)
            prev = "image"
            y = self._conv("backbone/stem", y, s[prev], s["backbone/stem"])
            prev = "backbone/stem"
            routes = []
            for i, n in enumerate(self.blocks):
                pre = f"backbone/stage{i}"
                y = self._conv(f"{pre}/down", y, s[prev], s[f"{pre}/down"], 2)
                prev = f"{pre}/down"
                for b in range(n):
                    k1, k2 = f"{pre}/res{b}/conv1", f"{pre}/res{b}/conv2"
                    r = self._conv(k1, y, s[prev], s[k1])
                    y = self._conv(k2, r, s[k1], s[k2], residual=y,
                                   res_scale=s[prev] / s[k2])
                    prev = k2
                if i >= _routes_from(self.blocks):
                    routes.append((y, prev))
            (c3, k3), (c4, k4), (c5, k5) = routes

            def head(name, y, prev):
                for j in range(6):
                    key = f"{name}/conv{j}"
                    y = self._conv(key, y, s[prev], s[key])
                    prev = key
                    if j == 4:
                        branch = y
                return self._conv(f"{name}/det", y, s[prev], None), branch

            def up_concat(up, br, head_key, route, route_key, cat):
                u = self._conv(up, br, s[head_key], s[up])
                u = _up2(self._requant(u, s[up], s[cat]))
                return torch.cat([u, self._requant(route, s[route_key], s[cat])], 1)

            d0, br = head("head0", c5, k5)
            d1, br = head("head1", up_concat("up0/conv", br, "head0/conv4", c4, k4, "concat1"),
                          "concat1")
            d2, _ = head("head2", up_concat("up1/conv", br, "head1/conv4", c3, k3, "concat2"),
                         "concat2")
        return tuple(d.permute(0, 2, 3, 1).contiguous() for d in (d0, d1, d2))
