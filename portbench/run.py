"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and limits are files found by name
(see ``portbench/__init__.py``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
slice of the window.  Without as many CUDA cards as the cell asks for, the
run fails and prints no result.  Build and kernel caches stay inside the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402


class Context:
    """What a generator is given: the cell, the run's arguments and device,
    and the set-up clock."""

    def __init__(self, cell: core.Cell, args, device):
        self.cell, self.cfg, self.mix = cell, cell.cfg, cell.mix
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = device
        self.setup_s = None

    def setup_done(self):
        self.setup_s = core.process_age_s()

    @staticmethod
    def log(msg: str):
        print(msg, file=sys.stderr, flush=True)


class MetricInputs:
    """What a per-layer metric's reader is given."""

    def __init__(self, cell: core.Cell, traced: dict):
        self.cell, self.cfg, self.mix = cell.name, cell.cfg, cell.mix
        self.trace = traced["trace"]
        self.calls = traced["calls"]
        self.images = traced["images"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = core.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell, args, device)
    out = cell.generator().run(ctx)

    found = core.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3

    correct, checks = core.verdict(out, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end() + cell.per_layer()}
    metrics = {}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                  "count": cell.chips, "memory_peak_bytes": out.get("memory_peak_bytes"),
                  "power": core.power_limit(), "torch": torch.__version__,
                  "cuda": torch.version.cuda}
    if args.trace:
        traced = out.get("trace")
        if traced is None:
            print("portbench: the traced slice did not complete", file=sys.stderr)
            return 4
        inputs = MetricInputs(cell, traced)
        for m in cell.per_layer():
            value = core.read_metric(m["name"], inputs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        tr = traced["trace"]
        device_rec["busy_s"] = tr.busy_s()
        device_rec["window_s"] = tr.window_s()
        result["breakdown"] = tr.breakdown()
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = device_rec
    result["checks"] = checks
    for k, v in out["checks"].items():
        if k not in checks:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
