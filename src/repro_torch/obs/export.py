"""Trace export: Chrome/Perfetto ``trace_event`` JSON and raw JSONL.

Two artifacts from one :class:`repro_torch.obs.trace.TraceRecorder`:

* :func:`write_chrome_trace` — the Trace Event Format Chrome's
  ``chrome://tracing`` and https://ui.perfetto.dev open directly:
  ``{"traceEvents": [...]}`` with complete (``"ph": "X"``) and instant
  (``"ph": "i"``) events plus ``"M"`` metadata naming the processes (one per
  clock domain: ``sim``, ``wall``) and threads (one per recorded track).
  Timestamps are microseconds (sim seconds × 1e6).
* :func:`write_jsonl` / :func:`read_jsonl` — the raw recorder events, one
  JSON object per line, loss-free (the report CLI's preferred input; it
  round-trips through :func:`events_from_dicts`).

:func:`validate_trace_events` checks the schema CI gates the trace artifact
on: every event has string ``name``/``ph``, integer ``pid``/``tid``, numeric
non-negative ``ts``; ``X`` events have numeric non-negative ``dur``; ``M``
events carry their ``args.name``.  Returns a list of violation strings
(empty = valid).

CLI::

    python -m repro_torch.obs.export --validate TRACE.json      # or .jsonl
    python -m repro_torch.obs.export --check-order TRACE.jsonl  # + ordering
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from .trace import CLOCK_SIM, CLOCK_WALL, TraceEvent, TraceRecorder

_CLOCK_PID = {CLOCK_SIM: 1, CLOCK_WALL: 2}
_VALID_PH = {"X", "i", "M", "C"}


# ------------------------------------------------------------ trace_event --
def _track_ids(events: Sequence[TraceEvent]) -> Dict[tuple, int]:
    """Deterministic (clock, track) -> tid assignment: sorted name order."""
    keys = sorted({(e.clock, e.track) for e in events})
    return {k: i + 1 for i, k in enumerate(keys)}


def to_trace_events(recorder_or_events) -> List[Dict[str, Any]]:
    """Convert recorder events to Chrome trace_event dicts (µs timestamps)."""
    events = recorder_or_events.events() \
        if isinstance(recorder_or_events, TraceRecorder) \
        else list(recorder_or_events)
    tids = _track_ids(events)
    out: List[Dict[str, Any]] = []
    for clock, pid in sorted(_CLOCK_PID.items()):
        if any(e.clock == clock for e in events):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "ts": 0,
                        "args": {"name": f"{clock} clock"}})
    for (clock, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "name": "thread_name",
                    "pid": _CLOCK_PID[clock], "tid": tid, "ts": 0,
                    "args": {"name": track}})
    for e in events:
        rec: Dict[str, Any] = {
            "ph": e.phase, "name": e.name, "cat": e.cat,
            "pid": _CLOCK_PID[e.clock], "tid": tids[(e.clock, e.track)],
            "ts": e.ts * 1e6,
        }
        if e.phase == "X":
            rec["dur"] = e.dur * 1e6
        elif e.phase == "i":
            rec["s"] = "t"          # thread-scoped instant
        if e.args:
            rec["args"] = dict(e.args)
        out.append(rec)
    return out


def write_chrome_trace(recorder_or_events, path: str, metrics=None) -> int:
    """Write the Perfetto-loadable JSON; returns the event count."""
    if isinstance(recorder_or_events, TraceRecorder):
        surface_drops(recorder_or_events, metrics)
    events = to_trace_events(recorder_or_events)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


# ------------------------------------------------------------------ JSONL --
# the JAX package's schema name: the two packages' JSONL files are the same
# format, and each package's readers take the other's
JSONL_SCHEMA = "repro.obs/trace.v1"


def surface_drops(recorder: TraceRecorder, metrics=None) -> int:
    """Make ring-buffer overflow loud: when the recorder dropped events,
    emit a ``slog`` warning and bump the ``trace_dropped_events`` counter
    (a truncated trace silently breaks every attribution built on it).
    Returns the drop count."""
    dropped = int(recorder.n_dropped)
    if dropped > 0:
        from .slog import get_logger
        get_logger("repro_torch.obs").warn(
            "trace_ring_overflow", dropped=dropped,
            capacity=int(recorder.capacity), kept=len(recorder.events()))
        if metrics is not None:
            c = metrics.counter("trace_dropped_events")
            c.inc(max(0, dropped - int(c.value)))
    return dropped


def write_jsonl(recorder_or_events, path: str, metrics=None) -> int:
    """Raw recorder events, one JSON object per line (loss-free), preceded
    by one header line stamping the recorder's drop accounting::

        {"header": "repro.obs/trace.v1", "n_events": ..., "n_dropped": ...,
         "capacity": ...}

    so downstream consumers (:mod:`repro_torch.obs.critpath`, the report
    CLI) can refuse silently-truncated inputs.  Returns the *event* count (the
    header line is metadata, not an event)."""
    is_rec = isinstance(recorder_or_events, TraceRecorder)
    events = recorder_or_events.events() if is_rec \
        else list(recorder_or_events)
    dropped = surface_drops(recorder_or_events, metrics) if is_rec else 0
    header = {"header": JSONL_SCHEMA, "n_events": len(events),
              "n_dropped": dropped,
              "capacity": (int(recorder_or_events.capacity)
                           if is_rec else None)}
    with open(path, "w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for e in events:
            f.write(json.dumps({
                "seq": e.seq, "clock": e.clock, "ph": e.phase, "cat": e.cat,
                "name": e.name, "track": e.track, "ts": e.ts, "dur": e.dur,
                "args": dict(e.args) if e.args else None},
                sort_keys=True) + "\n")
    return len(events)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def read_header(dicts: Iterable[Mapping[str, Any]]
                ) -> Optional[Mapping[str, Any]]:
    """The JSONL header from :func:`read_jsonl` output, or ``None`` for
    pre-header files (which by construction never reported drops)."""
    for d in dicts:
        if "header" in d and "seq" not in d:
            return d
        break
    return None


def events_from_dicts(dicts: Iterable[Mapping[str, Any]]) -> List[TraceEvent]:
    """Rebuild TraceEvents from :func:`read_jsonl` output (round-trip).
    Header/metadata lines (no ``seq``) are skipped."""
    return [TraceEvent(seq=int(d["seq"]), clock=d["clock"], phase=d["ph"],
                       cat=d["cat"], name=d["name"], track=d["track"],
                       ts=float(d["ts"]), dur=float(d.get("dur") or 0.0),
                       args=d.get("args"))
            for d in dicts if "seq" in d]


# ------------------------------------------------------------- validation --
def validate_trace_events(events: Iterable[Mapping[str, Any]]) -> List[str]:
    """Schema check for trace_event dicts; returns violation strings."""
    errors: List[str] = []
    n = 0
    for i, e in enumerate(events):
        n += 1
        where = f"event[{i}]"
        if not isinstance(e, Mapping):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if not isinstance(ph, str) or ph not in _VALID_PH:
            errors.append(f"{where}: ph={ph!r} not in {sorted(_VALID_PH)}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errors.append(f"{where}: missing/empty name")
        for field in ("pid", "tid"):
            if not isinstance(e.get(field), int):
                errors.append(f"{where}: {field} must be an integer, got "
                              f"{e.get(field)!r}")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number, got "
                          f"{ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs non-negative dur, "
                              f"got {dur!r}")
        if ph == "M":
            args = e.get("args")
            if not isinstance(args, Mapping) or "name" not in args:
                errors.append(f"{where}: M event needs args.name")
    if n == 0:
        errors.append("empty trace: no events")
    return errors


def load_trace_file(path: str) -> List[Dict[str, Any]]:
    """Load trace_event dicts from a chrome-trace .json or a recorder
    .jsonl (the latter is converted through :func:`to_trace_events`)."""
    if path.endswith(".jsonl"):
        return to_trace_events(events_from_dicts(read_jsonl(path)))
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, Mapping):
        return list(payload.get("traceEvents", []))
    return list(payload)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="TRACE .json (chrome trace) or .jsonl")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the artifact; non-zero exit on "
                         "violations")
    ap.add_argument("--check-order", action="store_true",
                    help="additionally run the repro_torch.check "
                         "happens-before checker (overlapping sends, "
                         "compute before inbound transfer)")
    args = ap.parse_args(argv)
    events = load_trace_file(args.path)
    errors = validate_trace_events(events)
    order_errors: List[str] = []
    if args.check_order:
        # function-local import: repro_torch.obs stays stdlib-only
        # importable; the happens-before pass is the check layer's
        from repro_torch.check.traceorder import (check_trace_order,
                                                  load_trace_events)
        order_errors = [str(f)
                        for f in check_trace_order(load_trace_events(
                            args.path))
                        if f.severity == "error"]
    if args.validate or args.check_order:
        bad = errors + order_errors
        if bad:
            print(f"{args.path}: INVALID ({len(bad)} violations)",
                  file=sys.stderr)
            for e in bad[:20]:
                print(f"  - {e}", file=sys.stderr)
            return 1
        ordered = ", happens-before ok" if args.check_order else ""
        print(f"{args.path}: OK ({len(events)} trace events, schema valid"
              f"{ordered})")
        return 0
    print(f"{len(events)} trace events, {len(errors)} violations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
