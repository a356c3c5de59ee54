"""Readings that set the YOLOv4 cell's limits, and the measurement behind
its seeded weights' variance scale, in one process on a card.

    python3 portbench/control_yolov4.py --seeds S1 S2 ... --control-seeds C1 C2 ...
    python3 portbench/control_yolov4.py --var-scales 1.0 1.3 2.0 --seeds S1 S2

Per seed it makes the cell's weights and scenes, serves ``sample_calls``
batches of the mix through the detector, and judges them as a run does
(``compare_yolov4.judge``), then holds the readings to the cell's
committed limits (``core.verdict``).  Two controls take the program's
place, each judged the same way: ``fp8``, the plain reference with every conv's
operands rounded to fp8 e4m3 (a precision below the configuration's bf16),
with the letterbox in TF32 and the postprocess in bfloat16; ``silu``, the
program (its plain versions, ``detect(plain=True)``) with Mish replaced by
SiLU everywhere.  ``--var-scales`` instead reports, per scale and seed, how
far the reference heads of two scenes lie apart (over their size), how far
the program's bf16 heads lie from the reference's, and the candidates above
0.5 a scene.  One JSON line a reading goes to standard output, with its
``correct``; the exit code is 1 where a control comes out correct or a
program reading does not.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from portbench import compare_yolov4, control, core, weights_yolov4  # noqa: E402
from portbench.generators import serve_closed_yolov4 as G4  # noqa: E402
from portbench.reference import letterbox as RL  # noqa: E402
from portbench.reference import yolov4 as RY4  # noqa: E402

CELL = "serve-yolov4-608-bf16-b32"


def readings(cfg: dict, mix: dict, seed: int, device, side: str) -> dict:
    from yolo_v3_tpu_torch import detector as detector_module
    from yolo_v3_tpu_torch.ops import activations

    params, state, pool, calib = G4.make_inputs(cfg, mix, seed, device)
    bsz, calls = mix["batch"], mix["sample_calls"]

    def batch(j):
        return pool[j * bsz:(j + 1) * bsz]

    heads_fn = compare_yolov4.reference_heads(cfg, params, state, calib, device)
    t0 = time.perf_counter()
    if side == "fp8":
        fp8 = compare_yolov4.reference_heads(cfg, params, state, calib, device,
                                             operand_round=RY4.fp8_round)
        samples = []
        for j in range(calls):
            x = RL.letterbox_batch(batch(j), cfg["input_size"], device).float()
            parts = [fp8(x[i:i + 8]) for i in range(0, bsz, 8)]
            samples.append({"batch": j, "heads": [torch.cat(h) for h in zip(*parts)]})
        nums = compare_yolov4.judge(samples, batch, cfg, mix, heads_fn, device,
                                    lb_precision="tf32", post_dtype=torch.bfloat16)
    else:
        det = G4.make_detector(cfg, mix, params, state, calib, device)
        saved = activations.mish, activations.mish_
        if side == "silu":
            det.detect = functools.partial(det.detect, plain=True)
            activations.mish, activations.mish_ = F.silu, lambda t: F.silu(t, inplace=True)
        try:
            samples = control.serve_samples(det, pool, mix, calls, detector_module)
        finally:
            activations.mish, activations.mish_ = saved
        del det
        nums = compare_yolov4.judge(samples, batch, cfg, mix, heads_fn, device)
    return {"seed": seed, "side": side, **nums, "seconds": time.perf_counter() - t0}


def var_scale_readings(cfg: dict, mix: dict, seed: int, device, scale: float) -> dict:
    """The variance scale's criterion at one seed (module docstring), on the
    pool's 8 measuring scenes and the next 8."""
    from portbench import scenes

    pool = scenes.make_pool(16, mix["sizes_wh"], seed + G4._G.SCENE_STREAM, device)
    params, state = weights_yolov4.make(cfg, seed, device, pool[:8], var_scale=scale)
    det = G4.make_detector(cfg, mix, params, state, None, device)
    out = {"seed": seed, "var_scale": scale}
    for name, imgs in (("measuring", pool[:8]), ("other", pool[8:])):
        x = RL.letterbox_batch(imgs, cfg["input_size"], device).float()
        ref = RY4.heads_float(params, state, x, cfg["blocks"])
        with torch.inference_mode():
            prog = det.model(x.to(torch.bfloat16))
        apart = rel = 0.0
        for h, p in zip(ref, prog):
            h = h.double()
            apart = max(apart, float((h[0::2] - h[1::2]).norm() / h.norm()))
            rel = max(rel, float((p.double() - h).norm() / h.norm()))
        cand = 0
        for h in ref:
            r = h.reshape(h.shape[0], -1, h.shape[-1] // 3)
            s = torch.sigmoid(r[..., 4]) * torch.sigmoid(r[..., 5:].amax(-1))
            cand += int((s > 0.5).sum())
        out.update({f"{name}.scenes_apart": apart, f"{name}.bf16_rel": rel,
                    f"{name}.candidates_a_scene": cand / len(imgs)})
    del det
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--var-scales", type=float, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = core.Cell(CELL)
    if not torch.cuda.is_available():
        print("portbench: control readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.var_scales:
        for scale in args.var_scales:
            for seed in args.seeds:
                r = var_scale_readings(cell.cfg, cell.mix, seed, device, scale)
                print(json.dumps({"workload": cell.name, **r}), flush=True)
                torch.cuda.empty_cache()
        return 0
    runs = [(s, "program") for s in args.seeds] + [
        (s, c) for s in args.control_seeds for c in ("fp8", "silu")]
    wrong = []
    for seed, side in runs:
        r = readings(cell.cfg, cell.mix, seed, device, side)
        # judged as a run is: the sampled calls, none failed, against the
        # cell's committed limits
        correct, _ = core.verdict({"checks": r, "attempted": cell.mix["sample_calls"],
                                   "failed": 0}, cell.limits)
        print(json.dumps({"workload": cell.name, **r, "correct": correct}), flush=True)
        if correct != (side == "program"):
            wrong.append((seed, side, correct))
        torch.cuda.empty_cache()
    if wrong:
        print(f"portbench: a control judged correct or a program reading not: {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
