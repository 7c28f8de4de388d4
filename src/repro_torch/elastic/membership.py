"""Churn-tolerant membership view (elastic runtime, beyond-paper).

FusionLLM's broker assumes the CompNode set fixed for a whole job; geo-
distributed volunteers actually churn (ATOM, arXiv:2403.10504; "Go With The
Flow", arXiv:2509.21221).  This module provides the deterministic membership
substrate the elastic controller runs on:

* :class:`ChurnEvent` / :class:`ChurnTrace` — scripted join/leave/slowdown/
  recover event traces (JSON-serializable), the reproducible stand-in for
  real churn;
* :class:`MembershipView` — heartbeat/lease semantics over a trace.  A node
  that leaves at time ``t`` stops heartbeating; the broker only *detects*
  the loss when the lease expires at ``t + lease_s`` (the detection delay
  the simulator charges).  Joins announce themselves and are admitted
  immediately.  Every batch of detected membership changes bumps the epoch
  counter — one epoch == one stable schedule.

Determinism contract (tested): the same trace polled at the same times
yields the same epochs, alive sets, and slowdown factors.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

EVENT_KINDS = ("join", "leave", "slowdown", "slowlink", "recover")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One scripted membership event.

    ``factor`` only matters for ``slowdown`` (multiplier on the node's
    effective compute speed) and ``slowlink`` (multiplier on the bandwidth of
    every link touching the node — its uplink silently congests below spec),
    both in (0, 1).  ``recover`` clears both.
    """

    time: float
    kind: str
    node: int
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown churn event kind {self.kind!r}")
        if self.kind in ("slowdown", "slowlink") \
                and not (0.0 < self.factor <= 1.0):
            raise ValueError(f"{self.kind} factor must be in (0, 1]")

    def to_dict(self) -> Dict:
        d = {"t": self.time, "kind": self.kind, "node": self.node}
        if self.kind in ("slowdown", "slowlink"):
            d["factor"] = self.factor
        return d

    @staticmethod
    def from_dict(d: Dict) -> "ChurnEvent":
        return ChurnEvent(time=float(d["t"]), kind=str(d["kind"]),
                          node=int(d["node"]),
                          factor=float(d.get("factor", 1.0)))


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """Time-ordered scripted events (stable-sorted by time on construction)."""

    events: Tuple[ChurnEvent, ...]

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events, key=lambda e: e.time)))

    def __len__(self) -> int:
        return len(self.events)

    def between(self, t0: float, t1: float) -> List[ChurnEvent]:
        """Events with t0 < time <= t1."""
        return [e for e in self.events if t0 < e.time <= t1]

    def to_json(self) -> str:
        return json.dumps([e.to_dict() for e in self.events])

    @staticmethod
    def from_json(text: str) -> "ChurnTrace":
        return ChurnTrace(tuple(ChurnEvent.from_dict(d)
                                for d in json.loads(text)))

    @staticmethod
    def build(events: Iterable[Dict]) -> "ChurnTrace":
        return ChurnTrace(tuple(ChurnEvent.from_dict(d) for d in events))


def single_failure_trace(node: int, at: float) -> ChurnTrace:
    """The acceptance-criteria trace: one node failure mid-training."""
    return ChurnTrace((ChurnEvent(time=at, kind="leave", node=node),))


@dataclasses.dataclass(frozen=True)
class MembershipDelta:
    """One detected change, stamped with when the broker learned of it."""

    event: ChurnEvent
    detected_at: float


class MembershipView:
    """Lease-based membership over a scripted trace.

    The broker's view, not ground truth: a departed node stays in ``alive``
    until its lease runs out.  ``poll(now)`` advances the view to ``now`` and
    returns the newly *detected* deltas; if any affect membership (join /
    leave), ``epoch`` increments once per poll (all changes detected together
    fold into one re-plan).

    ``slowdown`` / ``slowlink`` / ``recover`` events do NOT bump the epoch:
    they record the *ground-truth* factors (``slow_factor`` for compute,
    ``link_factor`` for a node's link bandwidths) the simulator degrades the
    real cluster by.  The broker is not told — its straggler detector has to
    notice compute drift from observed step times, and its link calibration
    has to notice bandwidth drift from observed transfers (that is the point
    of the exercise).
    """

    def __init__(self, n_nodes: int, trace: ChurnTrace,
                 lease_s: float = 10.0,
                 initial_alive: Optional[Sequence[int]] = None):
        if lease_s < 0:
            raise ValueError("lease_s must be >= 0")
        self.n_nodes = n_nodes
        self.trace = trace
        self.lease_s = float(lease_s)
        self.alive: List[int] = sorted(initial_alive) \
            if initial_alive is not None else list(range(n_nodes))
        self.slow_factor: Dict[int, float] = {}
        self.link_factor: Dict[int, float] = {}
        self.epoch = 0
        self.now = 0.0
        self._cursor = 0               # next undelivered trace event
        self._pending: List[MembershipDelta] = []   # leaves awaiting lease
        self.history: List[Tuple[int, MembershipDelta]] = []

    # ------------------------------------------------------------- polling
    def _detection_time(self, e: ChurnEvent) -> float:
        """Leaves are silent — detected at lease expiry.  Joins announce
        themselves; slowdowns are the straggler detector's job, surfaced
        here at event time so the ground-truth cluster degrades on cue."""
        return e.time + self.lease_s if e.kind == "leave" else e.time

    def poll(self, now: float) -> List[MembershipDelta]:
        if now < self.now:
            raise ValueError("time must be monotone")
        self.now = now
        while (self._cursor < len(self.trace.events)
               and self.trace.events[self._cursor].time <= now):
            e = self.trace.events[self._cursor]
            self._cursor += 1
            self._pending.append(MembershipDelta(e, self._detection_time(e)))
        ripe = [d for d in self._pending if d.detected_at <= now]
        self._pending = [d for d in self._pending if d.detected_at > now]
        changed = False
        for d in sorted(ripe, key=lambda d: d.detected_at):
            changed |= self._apply(d.event)
        if changed:
            self.epoch += 1
        for d in ripe:
            self.history.append((self.epoch, d))
        return ripe

    def _apply(self, e: ChurnEvent) -> bool:
        if e.kind == "leave":
            if e.node in self.alive:
                self.alive.remove(e.node)
                self.slow_factor.pop(e.node, None)
                self.link_factor.pop(e.node, None)
                return True
        elif e.kind == "join":
            if e.node not in self.alive:
                self.alive.append(e.node)
                self.alive.sort()
                return True
        elif e.kind == "slowdown":
            # ground truth only — the broker discovers this via the detector
            self.slow_factor[e.node] = e.factor
        elif e.kind == "slowlink":
            # ground truth only — link calibration has to measure it
            self.link_factor[e.node] = e.factor
        elif e.kind == "recover":
            self.slow_factor.pop(e.node, None)
            self.link_factor.pop(e.node, None)
        return False

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict:
        """Deterministic state fingerprint (the determinism tests hash it)."""
        return {"epoch": self.epoch, "now": self.now,
                "alive": list(self.alive),
                "slow": sorted(self.slow_factor.items()),
                "slowlink": sorted(self.link_factor.items())}
