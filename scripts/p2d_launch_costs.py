"""Split the int8 padded-2D conv kernel's launch time into its parts, on one
NVIDIA GPU.

    python3 scripts/p2d_launch_costs.py

Device time of one launch (CUDA-graph replay) with each tile shape of
``yolo_v3_tpu_torch.ops.fused_conv.P2D_TILES`` forced, at shapes that vary
one thing at a time:
- a launch of one tile (R = 9 rows): the fixed cost of a launch;
- the 1x1 at 104^2, C = 128 -> 64, batch 1 .. 16: the cost of a tile that
  has one K slot, from the slope over the tiles;
- the same at C = 1024 (8 K slots a tile): the cost of a K slot;
- the 3x3 at 104^2 with C = 64 (a 128-channel slot half zero-filled) and
  with C = 128: what the zero-filled half costs;
- the 1x1 at 52^2, 256 -> 128: the int8 forward's most launched 1x1.
Needs CUDA; imports no JAX.
"""

import functools
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from yolo_v3_tpu_torch.ops import fused_conv as FC  # noqa: E402

CASES = (  # (what, taps, batch, H = W, C, N, residual)
    ("one tile", 1, 1, 1, 128, 64, False),
    *((f"1x1 one K slot, batch {b}", 1, b, 104, 128, 64, False) for b in (1, 2, 4, 8, 16)),
    *((f"1x1 eight K slots, batch {b}", 1, b, 104, 1024, 64, False) for b in (1, 2, 4, 8)),
    ("3x3 C = 64 (slot half zeros)", 9, 8, 104, 64, 128, True),
    ("3x3 C = 128", 9, 8, 104, 128, 128, True),
    ("3x3 C = 64, no residual", 9, 8, 104, 64, 128, False),
    ("1x1 52^2", 1, 8, 52, 256, 128, False),
)


def main():
    if not torch.cuda.is_available():
        sys.exit("p2d_launch_costs: no CUDA device")
    card = S.card_line()
    gen = torch.Generator().manual_seed(3)
    tiles = [f"{64 * wgs}x{bn}" for wgs, bn, _ in FC.P2D_TILES]
    for what, taps, b, hw, c, n, residual in CASES:
        x2d = FC.pack_p2d(S.i8(gen, (b, hw, hw, c)))
        w = S.i8(gen, (3, 3, c, n) if taps == 9 else (c, n))
        m, bias = S.scale_bias(gen, n, taps * c)
        res = S.i8(gen, (x2d.shape[0], n), -127, 128) if residual else None
        rows, hp, wp = FC.p2d_geometry(b, hw, hw)
        conv = "conv3x3_p2d" if taps == 9 else "conv1x1_p2d"
        us = [1000 * S.device_ms(functools.partial(
                  FC._launch, conv, taps, x2d, w, m, bias, hp, wp, True, torch.int8, res, 0.7,
                  tiles=v), iters=20)
              for v in range(len(FC.P2D_TILES))]
        count = [-(-rows // (64 * wgs)) * -(-n // bn) for wgs, bn, _ in FC.P2D_TILES]
        print(f"cost {what}: R={rows} C={c} N={n} "
              + " ".join(f"{k}={u:.1f} us ({t} tiles)" for k, u, t in zip(tiles, us, count))
              + f" | {card}", flush=True)


if __name__ == "__main__":
    main()
