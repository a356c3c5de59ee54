"""The work of the bf16 stem and stride-2 convs of both models, counted from
their shapes (``counts.py``'s conventions and peaks).

YOLOv3: the convs of role ``stem`` and ``down`` in ``counts.conv_layers``
(the stem and 5 downs); YOLOv4: the stem and every stride-2 entry of
``counts_yolov4.conv_layers`` (5 Mish downs and PANet's 2 leaky ones).  Each
is one launch: its input read once, its weight, its float32 bias and its
output written once, whatever implements it.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import counts, counts_yolov4


def down_layers(cfg: Dict) -> List[Dict]:
    """The stem and the stride-2 convs of the cell's model, in forward order."""
    if cfg.get("arch") == "yolov4":
        layers = counts_yolov4.conv_layers(cfg["blocks"], cfg["classes"], cfg["input_size"])
        return [l for l in layers if l["role"] == "stem" or l["stride"] == 2]
    layers = counts.conv_layers(cfg["blocks"], cfg["classes"], cfg["input_size"])
    return [l for l in layers if l["role"] in ("stem", "down")]


def down_bound_s(cfg: Dict, batch: int) -> float:
    """Bound, in seconds, of one forward's stem and stride-2 convs at
    ``batch`` images: the sum of the launches' bounds (bf16 in, weights and
    out, float32 bias)."""
    return sum(counts.bound_s(2.0 * batch * counts.macs(l),
                              counts._conv_bytes(l, batch, 2, 2, 2, 4), "bf16")
               for l in down_layers(cfg))


def roofline_pct(m, kernel_pattern: str):
    """The stem and stride-2 convs' share of their roofline in a traced
    slice ``m``: their bound at the cell's shapes times the traced calls,
    over the device time of the kernels whose names match
    ``kernel_pattern``; None where no kernel matches."""
    t = m.trace.kernel_s(kernel_pattern)
    if t is None:
        return None
    return 100.0 * down_bound_s(m.cfg, m.mix["batch"]) * m.calls / t
