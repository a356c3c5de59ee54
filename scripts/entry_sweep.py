"""Time the int8 entry kernel's geometries on one NVIDIA GPU.

    python3 scripts/entry_sweep.py

For the int8 forward's entry at YOLOv3-416 (h = w = 104) at batch 8, 1 and
16, with chip_smoke.py's inputs: the device time of one launch of
``yolo_v3_tpu_torch.ops.entry_kernel.fused_entry``'s kernel (CUDA-graph
replay) for each band height in a set around the planner's pick, forced
through the wrapper's launcher and checked bit-equal to the plain version;
then the band ``plan_entry`` picks and the fastest.  These are the times
the planner's choice of band height rests on.
Needs CUDA; imports no JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from yolo_v3_tpu_torch.ops import entry_kernel as EK  # noqa: E402


def inputs(gen, b, h):
    xb = S.i8(gen, (b, 2 * h + 2, 2 * h + 2, 12), -127, 128)
    qs2d = {}
    for name, (kh, kw, cin, cout) in EK.SHAPES.items():
        m, bias = S.scale_bias(gen, cout, kh * kw * cin)
        qs2d[name] = {"w": S.i8(gen, (cin, cout) if kh == 1 else (kh, kw, cin, cout)),
                      "m": m, "b": bias}
    return xb, qs2d


def main():
    if not torch.cuda.is_available():
        sys.exit("entry_sweep: no CUDA device")
    card = S.card_line()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(1)
    h = 104
    for b in (8, 1, 16):
        xb, qs2d = inputs(gen, b, h)
        want = EK.fused_entry_ref(xb, qs2d, 0.6)
        plan, strips = EK.plan_entry(b, h, h, sms), -(-h // EK.STRIP)
        bands = sorted({plan["band"], max(1, plan["band"] // 2), 2 * plan["band"], 13, 26, 52})
        times = {}
        for band in (x for x in bands if x <= h):
            def run():
                return EK._launch(xb, qs2d, 0.6, band=band)
            S.check(torch.equal(run(), want), f"band {band} differs")
            times[band] = S.device_ms(run)
            print(f"entry sweep bs{b} 416: band {band:3d} ({b * -(-h // band) * strips} work "
                  f"items, {EK.band_steps(band)} steps a band): {times[band]:.4f} ms "
                  f"| {card}", flush=True)
        best = min(times, key=times.get)
        print(f"entry sweep bs{b} 416: planned band {plan['band']} {times[plan['band']]:.4f} ms; "
              f"fastest band {best} {times[best]:.4f} ms | {card}", flush=True)


if __name__ == "__main__":
    main()
