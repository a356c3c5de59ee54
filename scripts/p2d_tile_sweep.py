"""Time every tile shape of the padded-2D conv kernel on one NVIDIA GPU.

    python3 scripts/p2d_tile_sweep.py [bf16|int8 ...]   # default: both

For each conv of YOLOv3-416 at batch 8 that the kernel runs in the given
input types (chip_smoke.py's BF16_CONVS: the bf16 heads and up convs;
INT8_CONVS: every padded-2D conv of the int8 forward), the device time of
one launch with each shape of ``yolo_v3_tpu_torch.ops.fused_conv.P2D_TILES``
(CUDA-graph replay), the shape ``plan_tiles`` picks and the fastest; for
bf16 also the cuDNN bf16 chain on the same input; last, the per-forward
sums.  These are the times the planner's rates (``PLAN_RATES``) were
fitted to.  Needs CUDA; imports no JAX.
"""

import functools
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from yolo_v3_tpu_torch.ops import fused_conv as FC  # noqa: E402


def bf16_cases(gen):
    """(name, taps, hw, c, n, count, launch args, cuDNN yardstick) per bf16
    head and up conv."""
    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    for (taps, hw, c, n, leaky), count in S.BF16_CONVS.items():
        x2d = FC.pack_p2d(t(S.BATCH, hw, hw, c, scale=0.5))
        w = t(*((3, 3, c, n) if taps == 9 else (c, n)), scale=(taps * c) ** -0.5)
        ones, b = torch.ones(n, device="cuda"), t(n, scale=0.1, dtype=torch.float32)
        _, hp, wp = FC.p2d_geometry(S.BATCH, hw, hw)
        yield (f"{'3x3' if taps == 9 else '1x1'} bf16", taps, hw, c, n, count,
               (x2d, w, ones, b, hp, wp, leaky, torch.bfloat16, None, 1.0),
               S.cudnn_conv(x2d, w, b.bfloat16(), S.BATCH, hw, taps, leaky))


def int8_cases(gen):
    """The same per int8 conv, with chip_smoke.py's int8 inputs."""
    for (taps, hw, c, n, residual, out), count in S.INT8_CONVS.items():
        x2d = FC.pack_p2d(S.i8(gen, (S.BATCH, hw, hw, c)))
        w = S.i8(gen, (3, 3, c, n) if taps == 9 else (c, n))
        m, b = S.scale_bias(gen, n, taps * c)
        res = S.i8(gen, (x2d.shape[0], n), -127, 128) if residual else None
        _, hp, wp = FC.p2d_geometry(S.BATCH, hw, hw)
        od = torch.int8 if out == "i8" else torch.bfloat16
        yield (f"{'3x3' if taps == 9 else '1x1'} int8{' +res' if residual else ''} {out}",
               taps, hw, c, n, count, (x2d, w, m, b, hp, wp, out == "i8", od, res, 0.7), None)


def sweep(card, dtype, cases):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = [f"{64 * wgs}x{bn}" for wgs, bn, _ in FC.P2D_TILES]
    totals = dict.fromkeys(tiles + ["planned", "fastest"], 0.0)
    for what, taps, hw, c, n, count, args, library in cases:
        conv = "conv3x3_p2d" if taps == 9 else "conv1x1_p2d"
        ms = [S.device_ms(functools.partial(FC._launch, conv, taps, *args, tiles=v), iters=20)
              for v in range(len(FC.P2D_TILES))]
        rows = FC.p2d_geometry(S.BATCH, hw, hw)[0]
        plan = FC.plan_tiles(rows, c, n, taps, dtype, sms)
        best = ms.index(min(ms))
        line = " ".join(f"{k}={m:.4f}" for k, m in zip(tiles, ms))
        if library is not None:
            lib_ms = S.device_ms(library, iters=20)
            totals["cudnn"] = totals.get("cudnn", 0.0) + count * lib_ms
            line += f" cudnn={lib_ms:.4f}"
        print(f"sweep {what} [{S.BATCH},{hw},{hw},{c}]->{n} x{count}: {line} ms; planned "
              f"{tiles[plan]}, fastest {tiles[best]} | {card}", flush=True)
        for k, m in zip(tiles, ms):
            totals[k] += count * m
        totals["planned"] += count * ms[plan]
        totals["fastest"] += count * ms[best]
    print(f"sweep {S.NAMES.get(dtype, 'int8')} per forward (ms): "
          + " ".join(f"{k}={v:.4f}" for k, v in totals.items()) + f" | {card}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("p2d_tile_sweep: no CUDA device")
    modes = sys.argv[1:] or ["bf16", "int8"]
    if not set(modes) <= {"bf16", "int8"}:
        sys.exit("usage: p2d_tile_sweep.py [bf16|int8 ...]")
    card = S.card_line()
    for mode in modes:
        gen = torch.Generator().manual_seed(2)
        if mode == "bf16":
            sweep(card, torch.bfloat16, bf16_cases(gen))
        else:
            sweep(card, torch.int8, int8_cases(gen))


if __name__ == "__main__":
    main()
