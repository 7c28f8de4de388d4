"""ElasticController flight recorder.

Every broker decision becomes one structured, JSON-serializable record, so a
run can be *replayed*: why did a re-plan fire, what did the telemetry window
look like, which corrections passed hysteresis, what did each candidate
(including ``keep``) predict, and who won.  The record stream is the
debugging artifact the closed loop was missing — `churn.closed_loop`
recovering 1.41× is now fully explained by its own flight log (asserted in
tests).

Record kinds::

    calibration   one fit attempt: telemetry window snapshot, fitted values,
                  per-link hysteresis verdict (adopted | hysteresis | healed),
                  installed corrections after, detector repriced?, installed
                  vs calibrated pace, diverged verdict
    replan        one epoch transition: trigger cause + reason, dead/joined,
                  every candidate's predicted pace + migration bytes/seconds
                  + total score, the winner, plan-only hot swaps
    epoch         the installed epoch (mirrors EpochRecord, JSON-ready)
    detector      a straggler flag: node, severity, believed factor
    route         a serving router decision: session admitted onto a chain
                  of stage replicas, or re-routed mid-session around dead
                  replicas (with the replayed-KV token count and what the
                  alternative KV shipment would have cost on the wire)
    watchdog      a streaming SLO/anomaly trip: which rule fired, on which
                  signal (step seconds, a link's seconds, serving tokens/s),
                  the observed value vs the reference it violated

All records share ``kind``, ``step`` (data step) and ``clock`` (simulated
seconds).  :meth:`FlightRecorder.to_jsonl` / :func:`read_jsonl` round-trip
the log; the report CLI renders it next to the Perfetto trace.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple


def _link_key(link: Tuple[int, int]) -> str:
    return f"{link[0]}->{link[1]}"


@dataclasses.dataclass(frozen=True)
class CandidateScore:
    """One re-plan candidate as the broker priced it."""

    name: str                   # keep | anchored | full
    pace: float                 # predicted Eq. 3 steady-state pace (s)
    migration_bytes: float
    migration_seconds: float
    score: float                # migration_seconds + amortize_steps * pace
    winner: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CalibrationRecord:
    step: int
    clock: float
    window: Dict[str, int]            # link -> samples in the fit window
    fitted: Dict[str, float]          # link -> fitted correction
    verdicts: Dict[str, str]          # link -> adopted | hysteresis | healed
    installed: Dict[str, float]       # corrections in force after this fit
    repriced: bool                    # detector reference updated in place
    installed_pace: float             # pace the active plan was adopted at
    calibrated_pace: float            # the same plan under the new belief
    diverged: bool                    # past replan_pace_margin -> re-plan
    kind: str = "calibration"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ReplanRecord:
    step: int
    clock: float
    cause: str                        # failure | join | straggler | ...
    reason: str                       # human-readable trigger description
    dead: List[int]
    joined: List[int]
    candidates: List[CandidateScore]  # every candidate the broker priced
    winner: str
    plan_only: bool = False           # same cut, hot compression swap
    kind: str = "replan"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["candidates"] = [c.to_dict() if isinstance(c, CandidateScore)
                           else dict(c) for c in self.candidates]
        return d


@dataclasses.dataclass(frozen=True)
class EpochFlightRecord:
    step: int
    clock: float
    epoch: int
    cause: str
    stage_devices: List[int]
    n_moves: int
    moved_bytes: float
    migrate_seconds: float
    refill_seconds: float
    rollback_steps: int
    replan_mode: str = ""
    kind: str = "epoch"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RouteRecord:
    """One serving-router decision (``cause``: admit | reroute)."""

    step: int                         # decode round
    clock: float                      # simulated seconds
    session: str
    cause: str                        # admit | reroute
    dead: List[int]                   # replicas detected dead (reroute)
    old_chain: List[int]              # device per stage before the decision
    chain: List[int]                  # device per stage after
    replay_tokens: int                # tokens replayed onto replacements
    kv_ship_bytes: int                # what shipping the KV instead would cost
    kind: str = "route"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DetectorRecord:
    step: int
    clock: float
    node: int
    severity: float
    believed_factor: float
    kind: str = "detector"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class WatchdogRecord:
    """One watchdog trip (``rule``: slo | ewma | mad)."""

    step: int                         # training step or serving round
    clock: float                      # simulated seconds
    rule: str                         # slo | ewma | mad
    signal: str                       # step_seconds | link 3->5 | tokens_per_s
    value: float                      # the observation that tripped
    reference: float                  # SLO bound / EWMA mean / window median
    severity: float                   # |value - reference| / reference
    message: str = ""
    kind: str = "watchdog"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Bounded, ordered log of broker decisions.

    Always cheap enough to leave on: records are tiny dataclasses, the
    buffer is a ring (default 4096 records) and nothing is serialized until
    :meth:`to_jsonl` is called.
    """

    def __init__(self, capacity: int = 4096):
        self._buf: deque = deque(maxlen=int(capacity))

    def log(self, record) -> None:
        self._buf.append(record)

    def records(self, kind: Optional[str] = None) -> List[Any]:
        if kind is None:
            return list(self._buf)
        return [r for r in self._buf if r.kind == kind]

    def __len__(self) -> int:
        return len(self._buf)

    # -------------------------------------------------------- serialization --
    def to_dicts(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self._buf]

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.to_dicts():
                f.write(json.dumps(r, sort_keys=True) + "\n")


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a flight log written by :meth:`FlightRecorder.to_jsonl`."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def links_to_str(mapping: Mapping[Tuple[int, int], Any]) -> Dict[str, Any]:
    """JSON-friendly link keys: ``(i, j)`` -> ``"i->j"``, sorted."""
    return {_link_key(k): mapping[k] for k in sorted(mapping)}
