"""Loading a cell from its files, the process's clock, the device record and
the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_v3_tpu")
_T_IMPORT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (from the kernel's record of its
    start, so interpreter start-up counts; the module's import otherwise)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _T_IMPORT


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""

    def __init__(self, name: str, manifest: Optional[Dict] = None):
        self.manifest = manifest or load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.cfg = load_json(BENCH_DIR / "configs" / f"{self.entry['config']}.json")
        self.mix = load_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.spec = load_json(BENCH_DIR / "workloads" / f"{name}.json")
        self.limits: Dict[str, float] = self.spec["limits"]

    def generator(self) -> ModuleType:
        return load_module(BENCH_DIR / "generators" / f"{self.mix['generator']}.py",
                           f"portbench_generator_{self.mix['generator']}")

    def _applies(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.manifest["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[Dict]:
        return [m for m in self.manifest["per_layer"] if self._applies(m)]


def read_metric(name: str, inputs) -> Optional[float]:
    """The per-layer metric ``name`` from its reader, ``metrics/<name>.py``."""
    mod = load_module(BENCH_DIR / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    value = mod.read(inputs)
    return None if value is None else float(value)


def verdict(out: Dict, limits: Dict[str, float]):
    """(correct, checks): every compared number within its limit, calls
    attempted and none failed; ``checks`` maps each number to its value and
    limit."""
    checks = {k: {"value": out["checks"][k], "limit": lim} for k, lim in limits.items()}
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None
