"""Reading the device trace of a traced window.

The window runs under ``torch.profiler`` (host and CUDA activities) inside
a ``window`` annotation; the benchmark's own host spans are annotations
too (``executor``, ``update``, ``step_end``, ``data``).  The trace is
written as Chrome JSON into the checkout's ``build/portbench`` and read
back: device operations (kernels, copies, sets) with their times, and the
annotations.  From them:

* ``busy_s`` — the union of the device operations' intervals inside the
  window, ``window_s`` the window annotation's length;
* ``device_ops`` — device seconds by operation name, the largest first;
* ``idle_gaps`` — seconds of the window with no device operation, by the
  innermost benchmark span the host was in when each gap began (``host``
  where it was in none);
* ``kernel_s(pattern)`` — device seconds of operations whose name holds
  ``pattern``.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

SPANS = ("executor", "update", "step_end", "data")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "window"]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.ops: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                s, d = float(e["ts"]), float(e.get("dur", 0.0))
                if s + d > self.t0 and s < self.t1:
                    self.ops.append((max(s, self.t0), min(s + d, self.t1),
                                     str(e.get("name", "?"))))
        self.ops.sort()
        self.spans = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") in SPANS)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _ in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, n in self.ops:
            by[n[:160]] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def kernel_s(self, pattern: str) -> float:
        return sum(e - s for s, e, n in self.ops if pattern in n) * 1e-6

    def idle_gaps(self, top: int = 10) -> List[List]:
        gaps, prev = [], self.t0
        for s, e in self._merged():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        by: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            by[self._span_at(s)] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def _span_at(self, t: float) -> str:
        inner = "host"
        for s, e, n in self.spans:
            if s > t:
                break
            if e >= t:
                inner = n
        return inner


def read(prof, directory: Path) -> DeviceTrace:
    """Export ``prof``'s trace into ``directory``, read it, delete it."""
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return DeviceTrace(events)
