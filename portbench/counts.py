"""The work of YOLOv3's layers, counted from their shapes, and the card's peaks.

Every conv is listed with its input and output shapes; its operations are
2 x the multiply-adds of its output.  Its bytes follow the roofline
convention: each input byte read once, each output byte written once,
whatever a kernel reads again.  The bound of a launch is the larger of its
operations over the peak of their type and its bytes over HBM's rate; a
group's bound is the sum of its launches' bounds.  The count is of the work
a layer must do, so a later kernel that does the same work reads the same
count.
"""

from __future__ import annotations

from typing import Dict, List

# The card's published peaks (H100 SXM, dense, at 700 W).  fp32 products
# count as 3 TF32 products.
PEAK_OPS = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def conv_layers(blocks, num_classes: int, img: int) -> List[Dict]:
    """The 75 convs of YOLOv3 (Darknet-53 with ``blocks`` residual blocks a
    stage) at an ``img`` x ``img`` input, in forward order.  Each entry: name,
    role (stem / down / res1 / res2 / head / det / up), stage, h, w (of the
    output), cin, cout, k, stride."""
    out: List[Dict] = []

    def add(name, role, h, w, cin, cout, k, stride=1, stage=None):
        out.append(dict(name=name, role=role, stage=stage, h=h, w=w, cin=cin,
                        cout=cout, k=k, stride=stride))

    h = img
    add("stem", "stem", h, h, 3, 32, 3)
    c = 32
    grids = []
    for i, n in enumerate(blocks):
        h //= 2
        add(f"stage{i}/down", "down", h, h, c, 2 * c, 3, 2, i)
        c *= 2
        for b in range(n):
            add(f"stage{i}/res{b}/conv1", "res1", h, h, c, c // 2, 1, stage=i)
            add(f"stage{i}/res{b}/conv2", "res2", h, h, c // 2, c, 3, stage=i)
        grids.append((h, c))
    attrib = 3 * (5 + num_classes)
    (h3, c3), (h4, c4), (h5, c5) = grids[-3:]

    def head(name, hh, cin, f):
        nin = cin
        for j in range(3):
            add(f"{name}/conv{2 * j}", "head", hh, hh, nin, f, 1)
            add(f"{name}/conv{2 * j + 1}", "head", hh, hh, f, 2 * f, 3)
            nin = 2 * f
        add(f"{name}/det", "det", hh, hh, nin, attrib, 1)

    head("head0", h5, c5, 512)
    add("up0", "up", h5, h5, 512, 256, 1)
    head("head1", h4, 256 + c4, 256)
    add("up1", "up", h4, h4, 256, 128, 1)
    head("head2", h3, 128 + c3, 128)
    return out


def macs(layer: Dict) -> int:
    return layer["h"] * layer["w"] * layer["cout"] * layer["cin"] * layer["k"] ** 2


def forward_flops(blocks, num_classes: int, img: int) -> float:
    """Operations of one image's forward: 2 x the multiply-adds of every conv."""
    return 2.0 * sum(macs(l) for l in conv_layers(blocks, num_classes, img))


def bound_s(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take for one launch."""
    return max(ops / PEAK_OPS[kind], nbytes / HBM_BYTES_PER_S)


def _conv_bytes(l: Dict, batch: int, in_b: int, out_b: int, w_b: int,
                epi_b: int, residual: bool = False) -> float:
    pix_in = batch * l["h"] * l["stride"] * l["w"] * l["stride"]
    pix_out = batch * l["h"] * l["w"]
    n = (pix_in * l["cin"] * in_b + l["cin"] * l["k"] ** 2 * l["cout"] * w_b
         + pix_out * l["cout"] * out_b + l["cout"] * epi_b)
    if residual:
        n += pix_out * l["cout"] * in_b
    return n


def group_bound_s(group: str, blocks, num_classes: int, img: int, batch: int) -> float:
    """Bound, in seconds, of one forward's share of a kernel group at
    ``batch`` images: ``res_block_bf16`` (the residual blocks, two convs
    and the add a launch), ``p2d_bf16`` (the bf16 head, det and up convs),
    ``p2d_int8`` (the int8 convs of the blocks of stages 1-4 and the heads,
    one launch a conv), ``entry_int8`` (stem, down0, block 0 and down1, one
    launch whose intermediates stay on chip)."""
    layers = conv_layers(blocks, num_classes, img)
    total = 0.0
    if group == "res_block_bf16":
        for l1, l2 in zip(layers, layers[1:]):
            if l1["role"] == "res1" and l2["role"] == "res2":
                ops = 2.0 * batch * (macs(l1) + macs(l2))
                pix = batch * l2["h"] * l2["w"]
                nbytes = (2 * pix * l2["cout"] * 2
                          + 2 * (l1["cin"] * l1["cout"] + 9 * l2["cin"] * l2["cout"])
                          + 2 * (l1["cout"] + l2["cout"]))
                total += bound_s(ops, nbytes, "bf16")
    elif group == "p2d_bf16":
        for l in layers:
            if l["role"] in ("head", "det", "up"):
                total += bound_s(2.0 * batch * macs(l), _conv_bytes(l, batch, 2, 2, 2, 8),
                                 "bf16")
    elif group == "p2d_int8":
        for l in layers:
            inside = l["role"] in ("res1", "res2") and l["stage"] >= 1
            if inside or l["role"] in ("head", "det", "up"):
                out_b = 2 if l["role"] == "det" else 1
                total += bound_s(2.0 * batch * macs(l),
                                 _conv_bytes(l, batch, 1, out_b, 1, 8,
                                             residual=l["role"] == "res2"), "int8")
    elif group == "entry_int8":
        entry = [l for l in layers if l["role"] == "stem"
                 or (l["stage"] == 0) or l["name"] == "stage1/down"]
        ops = 2.0 * batch * sum(macs(l) for l in entry)
        last = entry[-1]
        nbytes = (batch * img * img * 3 + sum(l["cin"] * l["k"] ** 2 * l["cout"] + 8 * l["cout"]
                                              for l in entry)
                  + batch * last["h"] * last["w"] * last["cout"])
        total += bound_s(ops, nbytes, "int8")
    else:
        raise ValueError(f"unknown kernel group {group!r}")
    return total


def roofline_pct(m, group: str, kernel_pattern: str):
    """A kernel group's share of its roofline in a traced slice ``m``: the
    group's bound at the cell's shapes times the traced calls, over the
    device time of the kernels whose names match ``kernel_pattern``; None
    where no kernel matches."""
    t = m.trace.kernel_s(kernel_pattern)
    if t is None:
        return None
    c = m.cfg
    bound = group_bound_s(group, c["blocks"], c["classes"], c["input_size"], m.mix["batch"])
    return 100.0 * bound * m.calls / t
