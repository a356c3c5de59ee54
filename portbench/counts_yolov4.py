"""The work of YOLOv4's layers, counted from their shapes (``counts.py``'s
conventions and peaks).

The 110 convs of ``yolov4.cfg`` (arXiv:2004.10934) are listed in the cfg's
order with the tree paths the seeded weights and the port's YOLOv4 trees
share; the count is the same whichever kernel does the work.  The split
pair of a CSP stage reads one input, so the padded-2D group counts it as one
launch (its input read once, both outputs written).
"""

from __future__ import annotations

from typing import Dict, List

from portbench.counts import PEAK_OPS, bound_s, macs

__all__ = ["PEAK_OPS", "conv_layers", "forward_flops", "group_bound_s"]

# p2d-layout roles: the kernels' padded-2D convs
P2D_ROLES = ("split", "trans", "fuse", "neck", "head", "det")


def conv_layers(blocks, num_classes: int, img: int) -> List[Dict]:
    """The 110 convs at an ``img`` x ``img`` input, in the cfg's order.  Each
    entry: name (tree path), role (stem / down / split / res1 / res2 / trans
    / fuse: Mish; neck / pan_down / head: leaky; det: linear), stage, h, w
    (of the output), cin, cout, k, stride, act."""
    out: List[Dict] = []

    def add(name, role, h, cin, cout, k, stride=1, stage=None, act="leaky"):
        out.append(dict(name=name, role=role, stage=stage, h=h, w=h, cin=cin, cout=cout, k=k,
                        stride=stride, act=act))

    h = img
    add("backbone/stem", "stem", h, 3, 32, 3, act="mish")
    c = 32
    grids = []
    for i, n in enumerate(blocks):
        pre, cd = f"backbone/stage{i}", 2 * c
        part = cd if i == 0 else cd // 2
        mid = part // 2 if i == 0 else part
        h //= 2
        add(f"{pre}/down", "down", h, c, cd, 3, 2, i, "mish")
        add(f"{pre}/split0", "split", h, cd, part, 1, 1, i, "mish")
        add(f"{pre}/split1", "split", h, cd, part, 1, 1, i, "mish")
        for b in range(n):
            add(f"{pre}/res{b}/conv1", "res1", h, part, mid, 1, 1, i, "mish")
            add(f"{pre}/res{b}/conv2", "res2", h, mid, part, 3, 1, i, "mish")
        add(f"{pre}/trans", "trans", h, part, part, 1, 1, i, "mish")
        add(f"{pre}/fuse", "fuse", h, 2 * part, cd, 1, 1, i, "mish")
        grids.append(h)
        c = cd
    h3, h4, h5 = grids[-3:]
    attrib = 3 * (5 + num_classes)

    def five(pre, hh, cin, f):
        for j, (k, a, b) in enumerate(((1, cin, f), (3, f, 2 * f), (1, 2 * f, f),
                                       (3, f, 2 * f), (1, 2 * f, f))):
            add(f"{pre}/conv{j}", "neck", hh, a, b, k)

    for j, (k, a, b) in enumerate(((1, c, 512), (3, 512, 1024), (1, 1024, 512))):
        add(f"neck/spp_in/conv{j}", "neck", h5, a, b, k)
    for j, (k, a, b) in enumerate(((1, 2048, 512), (3, 512, 1024), (1, 1024, 512))):
        add(f"neck/spp_out/conv{j}", "neck", h5, a, b, k)
    add("neck/up0", "neck", h5, 512, 256, 1)
    add("neck/lat0", "neck", h4, 512, 256, 1)
    five("neck/td0", h4, 512, 256)
    add("neck/up1", "neck", h4, 256, 128, 1)
    add("neck/lat1", "neck", h3, 256, 128, 1)
    five("neck/td1", h3, 256, 128)
    add("head2/conv", "head", h3, 128, 256, 3)
    add("head2/det", "det", h3, 256, attrib, 1, act="linear")
    add("neck/down0", "pan_down", h4, 128, 256, 3, 2)
    five("neck/bu0", h4, 512, 256)
    add("head1/conv", "head", h4, 256, 512, 3)
    add("head1/det", "det", h4, 512, attrib, 1, act="linear")
    add("neck/down1", "pan_down", h5, 256, 512, 3, 2)
    five("neck/bu1", h5, 1024, 512)
    add("head0/conv", "head", h5, 512, 1024, 3)
    add("head0/det", "det", h5, 1024, attrib, 1, act="linear")
    return out


def forward_flops(blocks, num_classes: int, img: int) -> float:
    """Operations of one image's forward: 2 x the multiply-adds of every conv."""
    return 2.0 * sum(macs(l) for l in conv_layers(blocks, num_classes, img))


def _p2d_launches(layers: List[Dict]) -> List[Dict]:
    """The padded-2D convs as launches: each split pair merged into one."""
    out: List[Dict] = []
    for l in layers:
        if l["role"] not in P2D_ROLES:
            continue
        if l["role"] == "split" and l["name"].endswith("split1"):
            out[-1] = dict(out[-1], cout=out[-1]["cout"] + l["cout"])
            continue
        out.append(l)
    return out


def group_bound_s(group: str, blocks, num_classes: int, img: int, batch: int) -> float:
    """Bound, in seconds, of one forward's share of a kernel group at
    ``batch`` images: ``csp_block_bf16`` (the 23 CSP residual blocks, two
    convs and the add a launch: y in, out once, both weights and biases) or
    ``p2d_bf16`` (every padded-2D launch: the CSP split pairs, transitions
    and fuses, the neck's and heads' convs and the detection convs; bf16 in,
    weights and out, float32 scale and bias)."""
    layers = conv_layers(blocks, num_classes, img)
    total = 0.0
    if group == "csp_block_bf16":
        for l1, l2 in zip(layers, layers[1:]):
            if l1["role"] == "res1" and l2["role"] == "res2":
                ops = 2.0 * batch * (macs(l1) + macs(l2))
                pix = batch * l2["h"] * l2["w"]
                nbytes = (2 * pix * l2["cout"] * 2
                          + 2 * (l1["cin"] * l1["cout"] + 9 * l2["cin"] * l2["cout"])
                          + 2 * (l1["cout"] + l2["cout"]))
                total += bound_s(ops, nbytes, "bf16")
    elif group == "p2d_bf16":
        for l in _p2d_launches(layers):
            pix = batch * l["h"] * l["w"]
            nbytes = (2 * pix * (l["cin"] + l["cout"]) + 2 * l["k"] ** 2 * l["cin"] * l["cout"]
                      + 8 * l["cout"])
            total += bound_s(2.0 * batch * macs(l), nbytes, "bf16")
    else:
        raise ValueError(f"unknown kernel group {group!r}")
    return total


def roofline_pct(m, group: str, kernel_pattern: str):
    """A kernel group's share of its roofline in a traced slice ``m`` (as
    ``counts.roofline_pct``, with this file's groups); None where no kernel
    matches."""
    t = m.trace.kernel_s(kernel_pattern)
    if t is None:
        return None
    c = m.cfg
    bound = group_bound_s(group, c["blocks"], c["classes"], c["input_size"], m.mix["batch"])
    return 100.0 * bound * m.calls / t
