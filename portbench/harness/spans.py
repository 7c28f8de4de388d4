"""Reading the program's own spans from a traced window's device trace.

``repro_torch`` opens profiler ranges on its training path
(``repro_torch.obs.trace.span``): ``rad.step``, ``rad.fwd.s<i>``,
``rad.bwd.s<i>``, ``rad.wire``, ``attn`` and ``optim.update``.  On the
profiler's clock they lie beside the host's launch calls (``cuda_runtime``
and ``cuda_driver`` events) and the device operations, each of which
shares a ``correlation`` with the call that launched it.
:class:`SpanTrace` is a :class:`~portbench.harness.trace.DeviceTrace`,
whose readings it leaves as they are, that also answers for a span name:

* ``device_s`` — device seconds of the operations whose launch call began
  inside a span of that name, on any host thread (autograd's backward
  launches from a thread of its own while the caller waits in
  ``rad.bwd.s<i>``);
* ``launches`` — the count of those operations;
* ``idle_s`` — seconds of the window's idle gaps that began while the host
  was inside a span of that name (the rule of ``idle_gaps``).

``attn``'s backward has no span of its own: the profiler's ``fwdbwd``
flows link each operation of the forward inside an ``attn`` span to the
autograd node of its backward, and what those nodes launch counts as
``attn`` too.  Spans nest: a reading of ``rad.step`` holds those of the
spans inside it.  A trace without the program's spans (a program that
opens none) reads ``None``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.harness.trace import DEVICE_CATS, DeviceTrace

PREFIXES = ("rad.", "attn", "optim.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_SELF = "rad.step/self"


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _inside(t: float, union: List[Tuple[float, float]],
            starts: List[float]) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


class SpanTrace(DeviceTrace):
    def __init__(self, events: List[dict]):
        super().__init__(events)
        by_name: Dict[str, list] = defaultdict(list)
        for e in events:
            name = str(e.get("name", ""))
            if e.get("cat") == "user_annotation" and \
                    name.startswith(PREFIXES):
                s = float(e["ts"])
                end = s + float(e.get("dur", 0.0))
                if end > self.t0 and s < self.t1:
                    by_name[name].append((s, end))
        launch_ts = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launch_ts[corr] = float(e["ts"])
        # (launch ts, device seconds) of each device op launched in the window
        self.launched: List[Tuple[float, float]] = sorted(
            (launch_ts[c], float(e.get("dur", 0.0)) * 1e-6) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and (c := (e.get("args") or {}).get("correlation")) in launch_ts
            and self.t0 <= launch_ts[c] <= self.t1)
        if by_name.get("attn"):
            by_name["attn"] += self._backward_of(events, by_name["attn"])
        self.program_spans = {n: _union(v) for n, v in by_name.items()}

    @staticmethod
    def _backward_of(events, forward) -> List[Tuple[float, float]]:
        """Intervals of the autograd nodes that the ``fwdbwd`` flows link
        to operations inside ``forward``."""
        fwd = _union(forward)
        starts = [s for s, _ in fwd]
        begin, finish = {}, {}
        for e in events:
            if e.get("cat") != "fwdbwd":
                continue
            key = (e.get("pid"), e.get("tid"), float(e["ts"]))
            if e.get("ph") == "s":
                begin[e.get("id")] = key
            elif e.get("ph") == "f":
                finish[e.get("id")] = key
        wanted = {finish[i] for i, k in begin.items()
                  if i in finish and _inside(k[2], fwd, starts)}
        longest: Dict[tuple, float] = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") != "cpu_op":
                continue
            key = (e.get("pid"), e.get("tid"), float(e["ts"]))
            if key in wanted:
                longest[key] = max(longest.get(key, 0.0),
                                   float(e.get("dur", 0.0)))
        return [(k[2], k[2] + d) for k, d in longest.items()]

    def _ops_in(self, name: str, exclude: Tuple[str, ...] = ()
                ) -> Optional[List[float]]:
        union = self.program_spans.get(name)
        if not union:
            return None
        starts = [s for s, _ in union]
        other = _union(iv for n in exclude for iv in self.program_spans[n])
        other_starts = [s for s, _ in other]
        return [d for t, d in self.launched if _inside(t, union, starts)
                and not _inside(t, other, other_starts)]

    def device_s(self, name: str) -> Optional[float]:
        ops = self._ops_in(name)
        return None if ops is None else sum(ops)

    def launches(self, name: str) -> Optional[int]:
        ops = self._ops_in(name)
        return None if ops is None else len(ops)

    def idle_s(self, name: str) -> Optional[float]:
        union = self.program_spans.get(name)
        if not union:
            return None
        starts = [s for s, _ in union]
        return sum(e - s for s, e in self._gaps()
                   if _inside(s, union, starts)) * 1e-6

    def _gaps(self) -> List[Tuple[float, float]]:
        gaps, prev = [], self.t0
        for s, e in self._merged():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        return gaps

    def table(self, steps: int) -> Dict[str, Dict[str, float]]:
        """Each span name's device ms, launches and idle ms a step, and
        ``rad.step/self``: what ``rad.step`` launches outside every other
        span of the program (its own bookkeeping and passes)."""
        out = {}
        for name in sorted(self.program_spans):
            out[name] = {"device_ms": 1e3 * self.device_s(name) / steps,
                         "launches": self.launches(name) / steps,
                         "idle_ms": 1e3 * self.idle_s(name) / steps}
        if "rad.step" in self.program_spans:
            ops = self._ops_in("rad.step", tuple(
                n for n in self.program_spans if n != "rad.step"))
            out[STEP_SELF] = {"device_ms": 1e3 * sum(ops) / steps,
                              "launches": len(ops) / steps}
        return out


def readings(trace: SpanTrace, steps: int) -> Dict[str, float]:
    """The four per-step readings of the program's spans, those the trace
    can give: ``update_device_ms`` and ``update_launches`` (what
    ``optim.update`` launches), ``executor_idle_ms`` (idle gaps begun in
    ``rad.step``) and ``attn_ms`` (what ``attn`` and its backward
    launch)."""
    got = {"update_device_ms": (trace.device_s("optim.update"), 1e3),
           "update_launches": (trace.launches("optim.update"), 1),
           "executor_idle_ms": (trace.idle_s("rad.step"), 1e3),
           "attn_ms": (trace.device_s("attn"), 1e3)}
    return {k: v * scale / steps for k, (v, scale) in got.items()
            if v is not None and steps}
