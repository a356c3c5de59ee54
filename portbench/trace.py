"""The traced slice of a run: ``torch.profiler`` over a stated number of
calls, read back from its Chrome trace.

The benchmark marks its own spans with ``record_function`` (names
``portbench.<span>``), so the host's spans and the device's activity share
the trace's clock.  A device activity (kernel, copy or fill) belongs to the
span in which the host launched it (matched through the runtime call's
correlation id).  Busy time is the union of device intervals, not a sum of
kernel times.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")


def span(name: str, on: bool):
    """A ``record_function`` span of the benchmark's, or nothing."""
    return torch.profiler.record_function(SPAN_PREFIX + name) if on else contextlib.nullcontext()


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


class Trace:
    """The events of one exported trace, in microseconds of the host clock."""

    def __init__(self, events: List[Dict]):
        self.device: List[Dict] = []
        self.runtime: Dict[int, Dict] = {}
        self.runtime_all: List[Dict] = []
        self.spans: List[Dict] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                self.runtime_all.append(e)
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.runtime[corr] = e
            elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
                self.spans.append(e)
        self.device.sort(key=lambda e: e["ts"])
        self.spans.sort(key=lambda e: e["ts"])

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def spans_named(self, name: str) -> List[Dict]:
        return [s for s in self.spans if s["name"] == SPAN_PREFIX + name]

    def span_s(self, name: str) -> float:
        """Summed host time of the spans of ``name`` inside the window."""
        t0, t1 = self.window()
        return sum(s["dur"] for s in self.spans_named(name)
                   if t0 <= s["ts"] and s["ts"] + s["dur"] <= t1) / 1e6

    def window(self) -> Tuple[float, float]:
        s = self.spans_named("slice")
        if not s:
            raise ValueError("the trace has no portbench.slice span")
        return s[0]["ts"], s[0]["ts"] + s[0]["dur"]

    def window_s(self) -> float:
        t0, t1 = self.window()
        return (t1 - t0) / 1e6

    def device_in_window(self) -> List[Dict]:
        t0, t1 = self.window()
        return [e for e in self.device if e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]

    def busy_intervals(self, events: Optional[List[Dict]] = None) -> List[Tuple[float, float]]:
        """Union of the device intervals of ``events`` (default: all in the
        window), clipped to the window."""
        t0, t1 = self.window()
        ivs = sorted((max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1))
                     for e in (self.device_in_window() if events is None else events))
        out: List[Tuple[float, float]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self, events: Optional[List[Dict]] = None) -> float:
        return sum(b - a for a, b in self.busy_intervals(events)) / 1e6

    def launched_in(self, span_name: str) -> List[Dict]:
        """Device activities launched (by the host's runtime call) inside a
        span of ``span_name``."""
        spans = self.spans_named(span_name)
        starts = [s["ts"] for s in spans]
        out = []
        for e in self.device_in_window():
            rt = self.runtime.get(e.get("args", {}).get("correlation"))
            if rt is None:
                continue
            i = bisect.bisect_right(starts, rt["ts"]) - 1
            if i >= 0 and rt["ts"] <= spans[i]["ts"] + spans[i]["dur"]:
                out.append(e)
        return out

    def runtime_in_window(self, names) -> List[Dict]:
        t0, t1 = self.window()
        return [e for e in self.runtime_all if t0 <= e["ts"] <= t1 and e["name"] in names]

    def kernel_s(self, pattern: str) -> Optional[float]:
        """Summed device time of the kernels in the window whose name
        matches ``pattern``; None where none does."""
        rx = re.compile(pattern)
        ks = [e for e in self.device_in_window() if e.get("cat") == "kernel"
              and rx.search(e["name"])]
        return sum(e["dur"] for e in ks) / 1e6 if ks else None

    def host_span_at(self, t: float) -> str:
        """The innermost benchmark span open at ``t``: a stage's, else
        ``call`` (the entry point's own code between its stages), else
        ``harness`` (the benchmark's loop between calls)."""
        best = "harness"
        for s in self.spans:
            if s["ts"] > t:
                break
            name = s["name"][len(SPAN_PREFIX):]
            if name != "slice" and s["ts"] + s["dur"] >= t:
                best = name
        return best

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device activities that took most time, by short name, and the
        longest idle gaps, each named by the host span open at its start."""
        by_name: Dict[str, float] = {}
        for e in self.device_in_window():
            n = short_name(e["name"])
            by_name[n] = by_name.get(n, 0.0) + e.get("dur", 0) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        t0, t1 = self.window()
        busy = self.busy_intervals()
        gaps = []
        prev = t0
        for a, b in busy + [(t1, t1)]:
            if a > prev:
                gaps.append((self.host_span_at(prev), (a - prev) / 1e6))
            prev = max(prev, b)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def short_name(name: str) -> str:
    """A kernel's or copy's name without its template arguments and
    parameters, at most 80 characters."""
    for key in ("conv_p2d_kernel", "res_block_bf16_kernel", "res_block_f32_kernel",
                "fused_entry_kernel"):
        if key in name:
            kind = ("<bf16>" if "Bf16In" in name else "<i8>" if "I8In" in name else "")
            return key + kind
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:80] or name[:80]
