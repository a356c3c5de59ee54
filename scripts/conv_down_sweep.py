"""Time every tile shape and width of the bf16 stem / stride-2 conv kernel on
one NVIDIA GPU.

    python3 scripts/conv_down_sweep.py [BATCH]      # default 8

For each stride-2 conv of YOLOv3-416 and YOLOv4-608 (chip_smoke.py's
CONV_DOWN_SHAPES) at ``BATCH`` images, the device time of one launch with
each entry of ``yolo_v3_tpu_torch.ops.conv_down.DOWN_TILES`` at each tile
width (CUDA-graph replay), beside the shape ``plan_tiles`` picks, the
fastest and the bound; then the per-forward sums.  These are the times the
planner is judged by.  Needs CUDA; imports no JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from yolo_v3_tpu_torch.ops import conv_down as CD  # noqa: E402


def main(batch):
    card = S.card_line()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    totals = {}
    for model, name, c, n, hw, stride, act in S.CONV_DOWN_SHAPES:
        if stride != 2:
            continue
        x = torch.randn(batch, c, hw, hw, generator=gen).to("cuda", torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        w = (torch.randn(n, 3, 3, c, generator=gen) / (9 * c) ** 0.5).to("cuda", torch.bfloat16)
        wk = CD.kernel_weight(w.permute(0, 3, 1, 2))
        b32 = torch.randn(n, generator=gen).to("cuda")
        ho = hw // 2
        bound_ms, _ = S.bound(2 * batch * ho * ho * n * 9 * c,
                              2 * (batch * hw * hw * c + 9 * c * n + batch * ho * ho * n), "bf16")
        times = {}
        for v in range(len(CD.DOWN_TILES)):
            for wt in CD.TILE_WIDTHS:
                if wt <= 64 * CD.DOWN_TILES[v][0]:
                    times[(v, wt)] = S.device_ms(
                        lambda: CD._launch(x, wk, b32, 2, 1, act, tiles=(v, wt)))
        planned = CD.plan_tiles(batch, hw, hw, c, n, sms=sms)
        fastest = min(times, key=times.get)
        row = " ".join(f"{v}/{wt}:{t:.4f}" for (v, wt), t in times.items())
        print(f"{model} {name} [{batch},{hw},{hw},{c}]->{n}: {row} | planned {planned} "
              f"{times[planned]:.4f} fastest {fastest} {times[fastest]:.4f} bound "
              f"{bound_ms:.4f} | {card}", flush=True)
        tot = totals.setdefault(model, dict(planned=0.0, fastest=0.0, bound=0.0))
        tot["planned"] += times[planned]
        tot["fastest"] += times[fastest]
        tot["bound"] += bound_ms
    for model, tot in totals.items():
        print(f"{model} stride-2 convs at batch {batch}: planned {tot['planned']:.4f} ms, "
              f"fastest {tot['fastest']:.4f} ms, bound {tot['bound']:.4f} ms | {card}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else S.BATCH)
