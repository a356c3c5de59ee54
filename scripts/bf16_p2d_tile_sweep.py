"""Time every tile shape of the bf16 padded-2D conv kernel on one NVIDIA GPU.

    python3 scripts/bf16_p2d_tile_sweep.py

For each head and up conv of YOLOv3-416 at batch 8 (chip_smoke.py's
BF16_CONVS), the device time of one launch with each shape of
``yolo_v3_tpu_torch.ops.fused_conv.BF16_TILES`` (CUDA-graph replay), the
cuDNN bf16 chain on the same input, the shape ``plan_bf16`` picks and the
fastest; last, the per-forward sums.  These are the times the planner's cost
model was fitted to.  Needs CUDA; imports no JAX.
"""

import functools
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from yolo_v3_tpu_torch.ops import fused_conv as FC  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("bf16_p2d_tile_sweep: no CUDA device")
    card = S.card_line()
    gen = torch.Generator().manual_seed(2)

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    tiles = [f"{64 * wgs}x{bn}" for wgs, bn, _ in FC.BF16_TILES]
    totals = dict.fromkeys(tiles + ["planned", "fastest", "cudnn"], 0.0)
    for (taps, hw, c, n, leaky), count in S.BF16_CONVS.items():
        x2d = FC.pack_p2d(t(S.BATCH, hw, hw, c, scale=0.5))
        w = t(*((3, 3, c, n) if taps == 9 else (c, n)), scale=(taps * c) ** -0.5)
        ones, b = torch.ones(n, device="cuda"), t(n, scale=0.1, dtype=torch.float32)
        rows, hp, wp = FC.p2d_geometry(S.BATCH, hw, hw)
        name = "conv3x3_p2d" if taps == 9 else "conv1x1_p2d"
        ms = [S.device_ms(functools.partial(FC._launch, name, taps, x2d, w, ones, b, hp, wp,
                                            leaky, torch.bfloat16, None, 1.0, tiles=v),
                          iters=20)
              for v in range(len(FC.BF16_TILES))]
        cudnn = S.device_ms(S.cudnn_conv(x2d, w, b.bfloat16(), S.BATCH, hw, taps, leaky),
                            iters=20)
        plan = FC.plan_bf16(rows, c, n, taps, torch.cuda.get_device_properties(0)
                            .multi_processor_count)
        best = ms.index(min(ms))
        print(f"sweep {name} [{S.BATCH},{hw},{hw},{c}]->{n} x{count}: "
              + " ".join(f"{k}={m:.4f}" for k, m in zip(tiles, ms))
              + f" cudnn={cudnn:.4f} ms; planned {tiles[plan]}, fastest {tiles[best]}"
              f" | {card}", flush=True)
        for k, m in zip(tiles, ms):
            totals[k] += count * m
        totals["planned"] += count * ms[plan]
        totals["fastest"] += count * ms[best]
        totals["cudnn"] += count * cudnn
    print("sweep per forward (ms): " + " ".join(f"{k}={v:.4f}" for k, v in totals.items())
          + f" | {card}")


if __name__ == "__main__":
    main()
