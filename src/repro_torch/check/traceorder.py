"""Happens-before checker for ``obs`` span logs (repro_torch.check,
component 5).

``validate_trace_events`` is schema-only: it accepts a trace whose
spans are causally impossible.  This module replays a recorded span log
and verifies the ordering the sim executor promises:

* **monotonic tracks** — on every serial sim-clock resource track
  (``dev<i>`` compute, ``link a->b`` transfer, ``codec<i>`` encode)
  span starts are non-decreasing in record (``seq``) order,
* **serial links/devices** — within one training step no two spans on
  one such track overlap: a link never carries two sends at once, a
  device never computes two micro-batches at once,
* **compute-after-inbound** — a stage compute span
  (``F<st>.mb<m>`` / ``B<st>.mb<m>`` on ``dev<d>``) never starts before
  every inbound transfer feeding it (``Fxfer.mb<m>`` on
  ``link s-><d>`` of the same direction and step) has closed.

Step-scoped rules group spans by *execution attempt* — the
``(step, epoch)`` arg pair — because a rolled-back data step re-executes
under the next epoch with a different schedule and clock offset; pairing
the two attempts would be a false positive, not a causality bug.

Cross-step overlap is *not* flagged: the controller replays per-step
executor traces onto the broker clock, and overlapped migration
deliberately runs concurrently with training.  The ``migration`` track
is exempt from the serial rules by design (disjoint endpoint pairs
stream in parallel, so starts are not seq-monotonic there).

All comparisons use a relative tolerance — replay shifts and the µs
round-trip through the Chrome export cost a few ulps.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.export import events_from_dicts, read_jsonl
from repro_torch.obs.trace import (CAT_BWD, CAT_FWD, CAT_TRANSFER, CLOCK_SIM,
                             TraceEvent)

from .errors import Finding, SEV_WARN, TraceOrderError, raise_findings

# The sim span vocabulary, public: these regexes are the single source of
# truth for parsing executor traces — the critical-path analyzer
# (repro_torch.obs.critpath) builds its happens-before DAG from the same rules,
# so the two layers cannot drift apart.
XFER_RE = re.compile(r"^([FB])xfer\.mb(\d+)$")
LINK_RE = re.compile(r"^link (\d+)->(\d+)$")
COMP_RE = re.compile(r"^([FB])(\d+)\.mb(\d+)$")
DEV_RE = re.compile(r"^dev(\d+)$")
ENC_RE = re.compile(r"^([FB])enc\.mb(\d+)$")
CODEC_RE = re.compile(r"^codec(\d+)$")

# private aliases of the same regexes
_XFER_RE, _LINK_RE, _COMP_RE, _DEV_RE = XFER_RE, LINK_RE, COMP_RE, DEV_RE


def _is_serial_track(e: TraceEvent) -> bool:
    return e.clock == CLOCK_SIM and (
        DEV_RE.match(e.track) is not None
        or LINK_RE.match(e.track) is not None
        or CODEC_RE.match(e.track) is not None)


def _attempt_of(e: TraceEvent) -> Any:
    """One *execution attempt* of a data step: after a rollback the same
    step number re-executes under the next epoch, so spans are grouped by
    (step, epoch) — pairing across attempts would compare two different
    schedules' clocks."""
    args = e.args or {}
    return (args.get("step"), args.get("epoch"))


def _tolerance(spans: Sequence[TraceEvent], eps: float) -> float:
    hi = max((abs(e.ts) + abs(e.dur) for e in spans), default=1.0)
    return eps * max(1.0, hi)


def check_trace_order(events: Sequence[TraceEvent],
                      eps: float = 1e-9) -> List[Finding]:
    """Happens-before audit over recorder events (``phase == "X"`` spans
    drive the ordering rules; instants are only sanity-checked)."""
    out: List[Finding] = []
    spans: List[TraceEvent] = []
    for e in events:
        if not math.isfinite(e.ts) or not math.isfinite(e.dur) or e.dur < 0:
            out.append(Finding("bad-span", f"{e.track}/{e.name}",
                               f"span {e.name!r} on {e.track!r} has "
                               f"ts={e.ts!r} dur={e.dur!r}"))
            continue
        if e.phase == "X":
            spans.append(e)
    tol = _tolerance(spans, eps)

    # Rule A1: serial sim tracks are seq-monotonic in start time
    by_track: Dict[Tuple[str, str], List[TraceEvent]] = {}
    for e in spans:
        if _is_serial_track(e):
            by_track.setdefault((e.clock, e.track), []).append(e)
    for (clock, track), evs in sorted(by_track.items()):
        evs_seq = sorted(evs, key=lambda e: e.seq)
        for a, b in zip(evs_seq, evs_seq[1:]):
            if b.ts < a.ts - tol:
                out.append(Finding(
                    "nonmonotonic-track", track,
                    f"track {track!r}: span {b.name!r} (seq {b.seq}) starts "
                    f"at {b.ts:.6g}s, before the earlier-recorded "
                    f"{a.name!r} (seq {a.seq}) at {a.ts:.6g}s"))
                break
        # Rule A2: within one execution attempt the resource is serial
        by_step: Dict[Any, List[TraceEvent]] = {}
        for e in evs:
            by_step.setdefault(_attempt_of(e), []).append(e)
        for step, sevs in sorted(by_step.items(),
                                 key=lambda kv: repr(kv[0])):
            sevs = sorted(sevs, key=lambda e: (e.ts, e.seq))
            for a, b in zip(sevs, sevs[1:]):
                if b.ts < a.ts + a.dur - tol:
                    if track.startswith("link"):
                        what = "two sends in flight"
                    elif track.startswith("codec"):
                        what = "two encodes in flight"
                    else:
                        what = "two compute windows"
                    out.append(Finding(
                        "overlap", track,
                        f"track {track!r}"
                        + (f" step {step[0]}" if step[0] is not None else "")
                        + f": {what} — {b.name!r} starts at {b.ts:.6g}s "
                        f"inside {a.name!r} [{a.ts:.6g}, "
                        f"{a.ts + a.dur:.6g}]s"))
                    break

    # Rule B: no compute span starts before its inbound transfers close
    computes: Dict[Any, List[Tuple[TraceEvent, str, int, int]]] = {}
    for e in spans:
        if e.cat not in (CAT_FWD, CAT_BWD):
            continue
        mc, md = _COMP_RE.match(e.name), _DEV_RE.match(e.track)
        if mc and md:
            computes.setdefault((e.clock, _attempt_of(e)), []).append(
                (e, mc.group(1), int(mc.group(3)), int(md.group(1))))
    for e in spans:
        if e.cat != CAT_TRANSFER:
            continue
        mx, ml = _XFER_RE.match(e.name), _LINK_RE.match(e.track)
        if not (mx and ml):
            continue
        tag, mb = mx.group(1), int(mx.group(2))
        dst = int(ml.group(2))
        close = e.ts + e.dur
        cands = [c for (c, ctag, cmb, cdev)
                 in computes.get((e.clock, _attempt_of(e)), [])
                 if ctag == tag and cmb == mb and cdev == dst]
        if not cands:
            out.append(Finding(
                "orphan-transfer", f"{e.track}/{e.name}",
                f"transfer {e.name!r} on {e.track!r} feeds no recorded "
                f"compute span on dev{dst}", severity=SEV_WARN))
            continue
        consumer = min(cands, key=lambda c: c.ts)
        if consumer.ts < close - tol:
            out.append(Finding(
                "compute-before-transfer", f"dev{dst}/{consumer.name}",
                f"compute {consumer.name!r} on dev{dst} starts at "
                f"{consumer.ts:.6g}s before its inbound {e.name!r} on "
                f"{e.track!r} closes at {close:.6g}s"))
    return out


def load_trace_events(path: str) -> List[TraceEvent]:
    """Recorder events from a loss-free ``.jsonl`` or a Chrome-trace
    ``.json`` (clock/track reconstructed from the ``M`` metadata; ``seq``
    is the file order, which the exporter writes in ``(clock, ts, seq)``
    order)."""
    if path.endswith(".jsonl"):
        return events_from_dicts(read_jsonl(path))
    import json
    with open(path) as f:
        payload = json.load(f)
    raw = payload.get("traceEvents", []) \
        if isinstance(payload, Mapping) else payload
    pid_clock: Dict[int, str] = {}
    tid_track: Dict[Tuple[int, int], str] = {}
    for e in raw:
        if e.get("ph") != "M":
            continue
        name = (e.get("args") or {}).get("name", "")
        if e.get("name") == "process_name":
            pid_clock[e["pid"]] = str(name).split()[0]
        elif e.get("name") == "thread_name":
            tid_track[(e["pid"], e["tid"])] = str(name)
    out: List[TraceEvent] = []
    for i, e in enumerate(raw):
        ph = e.get("ph")
        if ph not in ("X", "i"):
            continue
        out.append(TraceEvent(
            seq=i, clock=pid_clock.get(e.get("pid"), CLOCK_SIM),
            phase=ph, cat=e.get("cat", ""), name=e.get("name", ""),
            track=tid_track.get((e.get("pid"), e.get("tid")), "?"),
            ts=float(e.get("ts", 0.0)) / 1e6,
            dur=float(e.get("dur", 0.0)) / 1e6,
            args=e.get("args")))
    return out


def verify_trace(events_or_path, eps: float = 1e-9,
                 strict: bool = False) -> List[Finding]:
    """Raise :class:`TraceOrderError` on any ordering violation.  Accepts
    a recorder, an event list, or a trace-file path."""
    if isinstance(events_or_path, str):
        events = load_trace_events(events_or_path)
    elif hasattr(events_or_path, "events"):
        events = events_or_path.events()
    else:
        events = list(events_or_path)
    findings = check_trace_order(events, eps=eps)
    return raise_findings(findings, TraceOrderError,
                          "trace failed happens-before verification",
                          strict=strict)
