"""Readings that set a serving cell's limits: the program's over many seeds
(the lower readings) and the control's (the upper ones), in one process.

    python3 portbench/control.py --workload <cell> --seeds S1 S2 ... --control-seeds C1 C2 ...

Per seed it makes the cell's weights and scenes, serves ``sample_calls``
batches of the mix through the detector (the cell's own load, closed loop),
and judges them as a run does (``compare.judge``).  The control puts the
step below the configuration's precision in the program's place: for bf16
the program's own int8 path; for int8 the reference computed in 4 bits; for
both, the letterbox in TF32 and the postprocess in bfloat16.  One JSON line
a seed and side goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, core  # noqa: E402
from portbench.generators import serve_closed as G  # noqa: E402


def serve_samples(det, pool, mix, calls, detector_module):
    """``calls`` batches through ``det``, in the window's order, with the
    letterboxed batch, heads and rows of each."""
    bsz = mix["batch"]
    probe = G.Probe(det, detector_module, False)
    out = []
    try:
        for j in range(calls):
            probe.keep = {}
            images = pool[j * bsz:(j + 1) * bsz]
            rows = det.detect(images)
            if not G.well_formed(rows, images, det.config.num_classes):
                raise RuntimeError(f"malformed rows in call {j}")
            out.append({"batch": j, "rows": rows, **probe.keep})
    finally:
        probe.close()
    return out


def readings(cfg: dict, mix: dict, seed: int, device, control: bool) -> dict:
    from yolo_v3_tpu_torch import detector as detector_module

    params, state, pool, calib = G.make_inputs(cfg, mix, seed, device)
    bsz, calls = mix["batch"], mix["sample_calls"]

    def batch(j):
        return pool[j * bsz:(j + 1) * bsz]

    t0 = time.perf_counter()
    if not control:
        det = G.make_detector(cfg, mix, params, state, calib, device)
        samples = serve_samples(det, pool, mix, calls, detector_module)
        del det
        heads_fn = compare.reference_heads(cfg, params, state, calib, device)
        nums = compare.judge(samples, batch, cfg, mix, heads_fn, device)
    elif cfg["precision"] == "bf16":
        det = G.make_detector(cfg, mix, params, state, pool[:mix["calib_images"]], device,
                              precision="int8")
        samples = serve_samples(det, pool, mix, calls, detector_module)
        del det
        heads_fn = compare.reference_heads(cfg, params, state, calib, device)
        nums = compare.judge(samples, batch, cfg, mix, heads_fn, device,
                             lb_precision="tf32", post_dtype=torch.bfloat16)
    else:
        from portbench.reference import letterbox as RL

        int4 = compare.int8_reference(cfg, params, state, calib, device, qmax=7)
        samples = [{"batch": j, "heads": int4.heads(
            RL.letterbox_batch(batch(j), cfg["input_size"], device).float())}
            for j in range(calls)]
        heads_fn = compare.reference_heads(cfg, params, state, calib, device)
        nums = compare.judge(samples, batch, cfg, mix, heads_fn, device,
                             lb_precision="tf32", post_dtype=torch.bfloat16)
    return {"seed": seed, "side": "control" if control else "program", **nums,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = core.Cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: control readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        r = readings(cell.cfg, cell.mix, seed, device, control)
        print(json.dumps({"workload": cell.name, **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
