"""``trace.Trace`` that also keeps the program's own spans (``yolo.*``,
``utils/profiling.py::span`` in the port), so that a reader can split the
forward's device time by the program's stages; the YOLOv4 cell's generator
builds its trace with it."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from portbench import trace

PROGRAM_PREFIX = "yolo."


class Trace(trace.Trace):
    def __init__(self, events: List[Dict]):
        super().__init__(events)
        self.program = sorted((e for e in events if e.get("ph") == "X"
                               and e.get("cat") == "user_annotation"
                               and e.get("name", "").startswith(PROGRAM_PREFIX)),
                              key=lambda e: e["ts"])

    def program_launched_in(self, name: str) -> List[Dict]:
        """Device activities in the window launched (by the host's runtime
        call) inside a program span ``yolo.<name>``."""
        spans = [s for s in self.program if s["name"] == PROGRAM_PREFIX + name]
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

    def program_device_ms(self, name: str, calls: int) -> Optional[float]:
        """Device ms a call (the union of the intervals) of the activities
        launched inside ``yolo.<name>``; None where there are none."""
        events = self.program_launched_in(name)
        return self.busy_s(events) / calls * 1e3 if events else None
