"""Run report: one readable artifact from a trace + flight-recorder pair.

    PYTHONPATH=src python -m repro_torch.obs.report TRACE.jsonl \
        [--flight FLIGHT.jsonl] [--width 100]

Renders, from the recorder's loss-free JSONL events (see
:mod:`repro_torch.obs.export`):

* a per-track ASCII **timeline** of the simulated clock (stage compute spans
  and link transfers, bucketed to the terminal width);
* the **comm/compute overlap fraction** — how much wire time was hidden
  under stage compute, the overlap Eq. 3 banks on;
* a **straggler heatmap** — per device × step busy seconds, row-normalized,
  so a degraded node shows as a bright row the moment it slows;
* the **critical path** — the blame table from
  :mod:`repro_torch.obs.critpath`: which device/link/codec the step time is
  actually waiting on, and for how many seconds per step;
* **top interventions** — Amdahl upper bounds per blamed resource ("if
  this link were free the step could shrink by at most X s"); exact
  counterfactual pricing lives in :mod:`repro_torch.obs.whatif`;
* the **decision log** — the flight recorder's calibration / re-plan /
  epoch / detector / watchdog records, one line each, in order.

All rendering is pure (lists in, string out) so tests assert on content, and
the CLI is a thin wrapper.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .trace import (CAT_BWD, CAT_FWD, CAT_TRANSFER, CLOCK_SIM, TraceEvent)
from .export import events_from_dicts, read_jsonl
from . import record as flight_record

_RAMP = " .:-=+*#%@"


# ------------------------------------------------------------- interval math
def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted union of [start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _measure(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two *merged* interval unions."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


# --------------------------------------------------------------- aggregates
def sim_events(events: Iterable[TraceEvent]) -> List[TraceEvent]:
    return [e for e in events if e.clock == CLOCK_SIM and e.phase == "X"]


def overlap_fraction(events: Iterable[TraceEvent]) -> Optional[float]:
    """Fraction of link-transfer wall-time that overlapped stage compute on
    the simulated clock (None when the trace has no transfers)."""
    evs = sim_events(events)
    compute = _union([(e.ts, e.ts + e.dur) for e in evs
                      if e.cat in (CAT_FWD, CAT_BWD)])
    comm = _union([(e.ts, e.ts + e.dur) for e in evs
                   if e.cat == CAT_TRANSFER])
    wire = _measure(comm)
    if wire <= 0.0:
        return None
    return _intersect(compute, comm) / wire


def stage_summary(events: Iterable[TraceEvent]
                  ) -> Dict[str, Dict[str, float]]:
    """Per sim-clock track: busy seconds by category group."""
    out: Dict[str, Dict[str, float]] = {}
    for e in sim_events(events):
        row = out.setdefault(e.track, {})
        key = {CAT_FWD: "fwd", CAT_BWD: "bwd"}.get(e.cat, e.cat)
        row[key] = row.get(key, 0.0) + e.dur
    return out


def straggler_matrix(events: Iterable[TraceEvent]
                     ) -> Tuple[List[str], List[int], List[List[float]]]:
    """(device tracks, steps, busy-seconds matrix) from compute spans whose
    args carry a ``step`` stamp (the controller's per-step replay)."""
    busy: Dict[Tuple[str, int], float] = {}
    for e in sim_events(events):
        if e.cat not in (CAT_FWD, CAT_BWD) or not e.args:
            continue
        step = e.args.get("step")
        if step is None:
            continue
        busy[(e.track, int(step))] = busy.get((e.track, int(step)), 0.0) \
            + e.dur
    tracks = sorted({t for t, _ in busy})
    steps = sorted({s for _, s in busy})
    matrix = [[busy.get((t, s), 0.0) for s in steps] for t in tracks]
    return tracks, steps, matrix


def render_heatmap(tracks: Sequence[str], steps: Sequence[int],
                   matrix: Sequence[Sequence[float]]) -> str:
    """Straggler heatmap: rows = devices, columns = steps, shade = busy
    seconds normalized by the *global* max (so a slowed device brightens
    relative to its healthy peers, column-wise drift shows re-plans)."""
    if not tracks:
        return "(no per-step compute spans in trace)"
    peak = max((v for row in matrix for v in row), default=0.0)
    lines = [f"steps {steps[0]}..{steps[-1]} ({len(steps)} cols), "
             f"peak {peak:.4g}s/step"]
    for t, row in zip(tracks, matrix):
        cells = "".join(
            _RAMP[min(len(_RAMP) - 1,
                      int(v / peak * (len(_RAMP) - 1)))] if peak > 0 else " "
            for v in row)
        lines.append(f"{t:>10s} |{cells}|")
    return "\n".join(lines)


def render_timeline(events: Iterable[TraceEvent], width: int = 80) -> str:
    """Per-track occupancy bars over the sim-clock extent, bucketed to
    ``width`` columns (a cell is shaded by its busy fraction)."""
    evs = sim_events(events)
    if not evs:
        return "(no sim-clock spans in trace)"
    t0 = min(e.ts for e in evs)
    t1 = max(e.ts + e.dur for e in evs)
    span = max(t1 - t0, 1e-12)
    tracks = sorted({e.track for e in evs})
    lines = [f"sim clock {t0:.4g}s .. {t1:.4g}s "
             f"({span:.4g}s across {width} cols)"]
    for t in tracks:
        frac = [0.0] * width
        for e in evs:
            if e.track != t:
                continue
            lo = (e.ts - t0) / span * width
            hi = (e.ts + e.dur - t0) / span * width
            c0, c1 = int(lo), min(width - 1, int(hi))
            for c in range(c0, c1 + 1):
                cell_lo, cell_hi = c, c + 1
                frac[c] += max(0.0, min(hi, cell_hi) - max(lo, cell_lo))
        cells = "".join(
            _RAMP[min(len(_RAMP) - 1, int(min(1.0, f) * (len(_RAMP) - 1)))]
            for f in frac)
        lines.append(f"{t:>14s} |{cells}|")
    return "\n".join(lines)


# ------------------------------------------------------------- decision log
def render_flight(records: Sequence[Mapping[str, Any]]) -> str:
    """One line per flight-recorder record, in log order."""
    if not records:
        return "(no flight records)"
    lines: List[str] = []
    for r in records:
        kind = r.get("kind", "?")
        head = f"[{r.get('step', '?'):>4}] t={float(r.get('clock', 0.0)):9.3f}s {kind:<11s}"
        if kind == "calibration":
            fits = ", ".join(f"{k}={v:.3g}({r['verdicts'].get(k, '?')})"
                             for k, v in sorted(r.get("fitted", {}).items()))
            lines.append(
                f"{head} fits: {fits or '(none)'}  installed="
                f"{ {k: round(v, 3) for k, v in sorted(r.get('installed', {}).items())} } "
                f"pace {r.get('installed_pace', 0.0):.4g}->"
                f"{r.get('calibrated_pace', 0.0):.4g} "
                f"{'DIVERGED -> re-plan' if r.get('diverged') else 'within margin'}")
        elif kind == "replan":
            cands = "  ".join(
                f"{c['name']}{'*' if c.get('winner') else ''}"
                f"(pace={c['pace']:.4g},mig={c['migration_seconds']:.3g}s"
                f"/{c['migration_bytes'] / 1e6:.3g}MB,"
                f"score={c['score']:.4g})"
                for c in r.get("candidates", []))
            lines.append(f"{head} cause={r.get('cause')} "
                         f"reason={r.get('reason')!r} "
                         f"dead={r.get('dead')} joined={r.get('joined')} "
                         f"-> {r.get('winner')}"
                         f"{' [plan-only hot swap]' if r.get('plan_only') else ''}\n"
                         f"{'':>32s}{cands}")
        elif kind == "epoch":
            lines.append(
                f"{head} #{r.get('epoch')} cause={r.get('cause')} "
                f"stages={r.get('stage_devices')} moves={r.get('n_moves')} "
                f"({float(r.get('moved_bytes', 0.0)) / 1e6:.3g}MB, "
                f"migrate {float(r.get('migrate_seconds', 0.0)):.3g}s + "
                f"refill {float(r.get('refill_seconds', 0.0)):.3g}s, "
                f"rollback {r.get('rollback_steps', 0)})")
        elif kind == "detector":
            lines.append(f"{head} node={r.get('node')} "
                         f"severity={float(r.get('severity', 0.0)):.3g} "
                         f"believed={float(r.get('believed_factor', 0.0)):.3g}")
        elif kind == "watchdog":
            lines.append(f"{head} {r.get('rule')} on {r.get('signal')!r}: "
                         f"value={float(r.get('value', 0.0)):.4g} vs "
                         f"ref={float(r.get('reference', 0.0)):.4g} "
                         f"(severity {float(r.get('severity', 0.0)):.3g})"
                         f"{' ' + r['message'] if r.get('message') else ''}")
        elif kind == "route":
            arrow = "" if r.get("cause") != "reroute" \
                else f" {r.get('old_chain')} ->"
            lines.append(
                f"{head} {r.get('cause')} s={r.get('session')}"
                f"{arrow} chain={r.get('chain')} dead={r.get('dead')} "
                f"replay={r.get('replay_tokens', 0)}tok "
                f"(kv-ship alt {int(r.get('kv_ship_bytes', 0)) / 1e6:.3g}MB)")
        else:
            lines.append(f"{head} {dict(r)}")
    return "\n".join(lines)


# ----------------------------------------------------------- critical path
def render_interventions(rows: Sequence[Any], n_attempts: int,
                         top: int = 5) -> str:
    """Amdahl upper bounds from blame rows: eliminating a resource outright
    can shave at most its critical-path seconds off each step.  (The exact
    counterfactual number — re-planned, re-overlapped — comes from
    :mod:`repro_torch.obs.whatif`; this section ranks what is *worth*
    re-pricing.)
    """
    ranked = [r for r in rows if r.kind != "stall"][:top]
    if not ranked or n_attempts == 0:
        return "(nothing on the critical path to intervene on)"
    lines = []
    for i, r in enumerate(ranked):
        lines.append(f"{i + 1}. if {r.kind} {r.track or '?'} were free: "
                     f"<= {r.mean_seconds:.4g} s/step back "
                     f"({r.share * 100:.1f}% of the critical path, "
                     f"on-path {r.steps_on_path}/{r.n_steps} steps)")
    return "\n".join(lines)


def render_critpath(events: Sequence[TraceEvent], top: int = 8
                    ) -> Tuple[str, str]:
    """(blame-table text, interventions text) for :func:`build_report`."""
    from . import critpath
    decomps = critpath.analyze(events)
    if not decomps:
        return ("(no attributable sim spans in trace)",
                "(nothing on the critical path to intervene on)")
    rows = critpath.blame(decomps)
    mean_make = sum(d.makespan for d in decomps) / len(decomps)
    header = (f"{len(decomps)} step attempt(s), "
              f"mean makespan {mean_make:.4g}s")
    return (header + "\n" + critpath.render_blame(rows, top=top),
            render_interventions(rows, len(decomps)))


# ------------------------------------------------------------------ report
def build_report(events: Sequence[TraceEvent],
                 flight: Optional[Sequence[Mapping[str, Any]]] = None,
                 width: int = 80) -> str:
    """The full run report (pure: render only, no I/O)."""
    parts: List[str] = []
    parts.append("== timeline " + "=" * max(0, width - 12))
    parts.append(render_timeline(events, width=width))
    ov = overlap_fraction(events)
    parts.append("")
    parts.append("== comm/compute overlap " + "=" * max(0, width - 24))
    parts.append("no link transfers traced" if ov is None else
                 f"{ov * 100:.1f}% of wire seconds overlapped stage compute")
    summary = stage_summary(events)
    if summary:
        parts.append("")
        parts.append("== per-track busy seconds " + "=" * max(0, width - 26))
        for track in sorted(summary):
            row = summary[track]
            cells = "  ".join(f"{k}={v:.4g}s" for k, v in sorted(row.items()))
            parts.append(f"{track:>14s}  {cells}")
    tracks, steps, matrix = straggler_matrix(events)
    parts.append("")
    parts.append("== straggler heatmap " + "=" * max(0, width - 21))
    parts.append(render_heatmap(tracks, steps, matrix))
    blame_text, iv_text = render_critpath(events)
    parts.append("")
    parts.append("== critical path " + "=" * max(0, width - 17))
    parts.append(blame_text)
    parts.append("")
    parts.append("== top interventions " + "=" * max(0, width - 21))
    parts.append(iv_text)
    parts.append("")
    parts.append("== decision log " + "=" * max(0, width - 16))
    parts.append(render_flight(flight or []))
    return "\n".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="recorder JSONL (from obs.export.write_jsonl)")
    ap.add_argument("--flight", default=None,
                    help="flight-recorder JSONL (FlightRecorder.to_jsonl)")
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--allow-truncated", action="store_true",
                    help="render even when the trace header reports dropped "
                         "events (ring-buffer overflow)")
    args = ap.parse_args(argv)
    dicts = read_jsonl(args.trace)
    from .export import read_header
    header = read_header(dicts)
    dropped = int((header or {}).get("n_dropped", 0))
    if dropped > 0 and not args.allow_truncated:
        print(f"{args.trace}: REFUSED — header reports {dropped} dropped "
              f"events (ring-buffer overflow); pass --allow-truncated to "
              f"render anyway.", file=sys.stderr)
        return 2
    events = events_from_dicts(dicts)
    flight = flight_record.read_jsonl(args.flight) if args.flight else None
    print(build_report(events, flight, width=args.width))
    return 0


if __name__ == "__main__":
    sys.exit(main())
