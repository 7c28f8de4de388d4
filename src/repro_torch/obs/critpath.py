"""Critical-path analyzer: bottleneck attribution over recorded span logs.

    PYTHONPATH=src python -m repro_torch.obs.critpath TRACE.jsonl \
        [--top 10] [--json CRITPATH.json] [--expect-busy METRICS.json]

The simulator (and the controller's per-step replay) emits a span per stage
compute window, per link transfer, and per codec encode.  Those spans are a
complete happens-before DAG of one training step: every span's start time
equals the finish time of whatever it waited on — an inbound transfer, the
same device's previous micro-batch, the link's previous send, the codec
stream — because the discrete-event executor computes starts exactly that
way.  This module inverts that construction:

* :func:`analyze` groups spans by *execution attempt* (the ``(step, epoch)``
  arg pair, the same grouping :mod:`repro_torch.check.traceorder` uses) and
  walks the chain of binding waits backwards from the last-finishing span,
  decomposing each step's makespan into per-device **compute**, per-link
  **wire**, per-codec-stream **codec** and residual **stall** seconds;
* :func:`blame` aggregates the decompositions into a blame table — "link
  3->5 is on the critical path 62% of steps, 1.8 s/step of slack behind
  it" — the objective-gradient the planner's what-if engine
  (:mod:`repro_torch.obs.whatif`) re-prices;
* :func:`busy_accounting` sums *all* spans (critical or not) per resource,
  and :func:`check_sim_busy` gates that total against the simulator's own
  ``SimResult`` busy accounting (CI fails the trace artifact when the two
  disagree beyond 1% — a drifted span vocabulary would silently rot every
  report built on it).

Attribution refuses silently-truncated inputs: a JSONL whose header stamps
``n_dropped > 0`` (ring-buffer overflow, see
:func:`repro_torch.obs.export.write_jsonl`) is rejected unless
``--allow-truncated`` is passed — a blame table over a partial step is worse
than none.

The module is import-light (stdlib only at import time; the traceorder edge
rules are pulled lazily) so ``import repro_torch.obs`` stays dependency-free.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

from .trace import (CAT_BWD, CAT_ENCODE, CAT_FWD, CAT_SERVE_PREFILL,
                    CAT_SERVE_REPLAY, CAT_TRANSFER, CLOCK_SIM, TraceEvent)

# span kind on the critical path (and in the blame table)
KIND_COMPUTE = "compute"
KIND_WIRE = "wire"
KIND_CODEC = "codec"
KIND_STALL = "stall"

_CAT_KIND = {CAT_FWD: KIND_COMPUTE, CAT_BWD: KIND_COMPUTE,
             CAT_SERVE_PREFILL: KIND_COMPUTE, CAT_SERVE_REPLAY: KIND_COMPUTE,
             CAT_TRANSFER: KIND_WIRE, CAT_ENCODE: KIND_CODEC}

# relative float tolerance for "span A's finish *is* span B's start" — the
# same budget the trace-order checker grants replay shifts and the µs
# round-trip through the Chrome export
_EPS = 1e-9


def _edge_rules():
    """The traceorder name/track regexes (lazy: obs stays import-light,
    and the two modules cannot drift — one source of truth for the span
    vocabulary)."""
    from repro_torch.check.traceorder import (CODEC_RE, COMP_RE, DEV_RE,
                                              ENC_RE, LINK_RE, XFER_RE)
    return XFER_RE, LINK_RE, COMP_RE, DEV_RE, ENC_RE, CODEC_RE


@dataclasses.dataclass(frozen=True)
class CritSegment:
    """One span (or gap) on a step's critical path."""

    kind: str                  # compute | wire | codec | stall
    track: str                 # dev3 | link 3->5 | codec3 | "" for stall
    name: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "track": self.track, "name": self.name,
                "start": self.start, "end": self.end,
                "seconds": self.seconds}


@dataclasses.dataclass
class StepDecomposition:
    """One execution attempt's makespan, split along its critical path."""

    attempt: Tuple[Any, Any]             # (step, epoch) args, or (None, None)
    t0: float                            # earliest span start
    t1: float                            # latest span finish
    segments: List[CritSegment]
    compute: Dict[str, float]            # dev track -> critical seconds
    wire: Dict[str, float]               # link track -> critical seconds
    codec: Dict[str, float]              # codec track -> critical seconds
    stall: float                         # makespan not covered by any span

    @property
    def makespan(self) -> float:
        return self.t1 - self.t0

    def total(self) -> float:
        return (sum(self.compute.values()) + sum(self.wire.values())
                + sum(self.codec.values()) + self.stall)

    def to_dict(self) -> Dict[str, Any]:
        return {"attempt": {"step": self.attempt[0], "epoch": self.attempt[1]},
                "t0": self.t0, "t1": self.t1, "makespan": self.makespan,
                "compute": dict(sorted(self.compute.items())),
                "wire": dict(sorted(self.wire.items())),
                "codec": dict(sorted(self.codec.items())),
                "stall": self.stall,
                "path": [s.to_dict() for s in self.segments]}


@dataclasses.dataclass(frozen=True)
class BlameRow:
    """One resource's share of the critical path across analyzed steps."""

    kind: str                 # compute | wire | codec | stall
    track: str
    crit_seconds: float       # total critical-path seconds attributed
    steps_on_path: int        # attempts where the resource appears at all
    n_steps: int              # attempts analyzed
    mean_seconds: float       # crit_seconds / n_steps — s/step of slack
    share: float              # fraction of all critical seconds

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------- parsing --
def _dag_spans(events: Iterable[TraceEvent]) -> List[TraceEvent]:
    """The sim-clock complete spans that participate in the step DAG."""
    return [e for e in events
            if e.clock == CLOCK_SIM and e.phase == "X" and e.cat in _CAT_KIND]


def _attempt_of(e: TraceEvent) -> Tuple[Any, Any]:
    args = e.args or {}
    return (args.get("step"), args.get("epoch"))


class _Meta:
    """Parsed identity of one span: enough to test 'does p feed s?'."""

    __slots__ = ("ev", "kind", "tag", "mb", "src", "dst", "dev")

    def __init__(self, ev: TraceEvent, rules):
        xfer_re, link_re, comp_re, dev_re, enc_re, codec_re = rules
        self.ev = ev
        self.kind = _CAT_KIND[ev.cat]
        self.tag = self.mb = self.src = self.dst = self.dev = None
        if self.kind == KIND_COMPUTE:
            mc, md = comp_re.match(ev.name), dev_re.match(ev.track)
            if md:
                self.dev = int(md.group(1))
            if mc:
                self.tag, self.mb = mc.group(1), int(mc.group(3))
        elif self.kind == KIND_WIRE:
            mx, ml = xfer_re.match(ev.name), link_re.match(ev.track)
            if ml:
                self.src, self.dst = int(ml.group(1)), int(ml.group(2))
            if mx:
                self.tag, self.mb = mx.group(1), int(mx.group(2))
        elif self.kind == KIND_CODEC:
            me, mc = enc_re.match(ev.name), codec_re.match(ev.track)
            if mc:
                self.src = int(mc.group(1))
            if me:
                self.tag, self.mb = me.group(1), int(me.group(2))

    @property
    def end(self) -> float:
        return self.ev.ts + self.ev.dur

    def feeds(self, s: "_Meta") -> bool:
        """True when this span is a *causal* producer of ``s`` under the
        executor's construction (not merely earlier on the same resource)."""
        if self.tag is None or s.tag is None or self.tag != s.tag \
                or self.mb != s.mb:
            return False
        if s.kind == KIND_COMPUTE:
            # inbound transfer into the consuming device
            return self.kind == KIND_WIRE and self.dst == s.dev
        if s.kind == KIND_WIRE:
            # producer compute on the source device, or its codec stream
            if self.kind == KIND_COMPUTE:
                return self.dev == s.src
            if self.kind == KIND_CODEC:
                return self.src == s.src
            return False
        if s.kind == KIND_CODEC:
            # codec encodes the producing stage's output on the same device
            return self.kind == KIND_COMPUTE and self.dev == s.src
        return False


def _walk_attempt(metas: List[_Meta], tol: float
                  ) -> Tuple[List[CritSegment], float, float, float]:
    """Critical path of one attempt: start from the last-finishing span and
    repeatedly jump to the predecessor whose finish time *is* the current
    span's start (causal feeds preferred, then same-track serial order).
    Residual gaps (no span ends at the current start) are stalls."""
    t0 = min(m.ev.ts for m in metas)
    t1 = max(m.end for m in metas)
    by_end = sorted(metas, key=lambda m: (m.end, m.ev.seq))
    ends = [m.end for m in by_end]
    segments: List[CritSegment] = []
    stall = 0.0
    cur = by_end[-1]
    visited = set()
    while True:
        visited.add(id(cur))
        segments.append(CritSegment(
            kind=cur.kind, track=cur.ev.track, name=cur.ev.name,
            start=cur.ev.ts, end=cur.end))
        if cur.ev.ts <= t0 + tol:
            break
        # spans finishing at (or before) the current start
        hi = bisect.bisect_right(ends, cur.ev.ts + tol)
        cands = [m for m in by_end[:hi] if id(m) not in visited]
        if not cands:
            stall += cur.ev.ts - t0
            break
        best_end = max(m.end for m in cands)
        exact = [m for m in cands if m.end >= best_end - tol]
        # binding wait: a causal feed beats serial-resource order beats any
        nxt = next((m for m in exact if m.feeds(cur)), None) \
            or next((m for m in exact if m.ev.track == cur.ev.track), None) \
            or exact[0]
        gap = cur.ev.ts - nxt.end
        if gap > tol:
            stall += gap
            segments.append(CritSegment(
                kind=KIND_STALL, track="", name="(stall)",
                start=nxt.end, end=cur.ev.ts))
        cur = nxt
    segments.reverse()
    return segments, t0, t1, stall


def analyze(events: Iterable[TraceEvent]) -> List[StepDecomposition]:
    """Per-attempt critical-path decompositions, sorted by attempt key."""
    rules = _edge_rules()
    attempts: Dict[Tuple[Any, Any], List[_Meta]] = {}
    for e in _dag_spans(events):
        attempts.setdefault(_attempt_of(e), []).append(_Meta(e, rules))
    out: List[StepDecomposition] = []
    for key in sorted(attempts, key=repr):
        metas = attempts[key]
        hi = max((abs(m.ev.ts) + abs(m.ev.dur) for m in metas), default=1.0)
        tol = _EPS * max(1.0, hi)
        segments, t0, t1, stall = _walk_attempt(metas, tol)
        compute: Dict[str, float] = {}
        wire: Dict[str, float] = {}
        codec: Dict[str, float] = {}
        sink = {KIND_COMPUTE: compute, KIND_WIRE: wire, KIND_CODEC: codec}
        for seg in segments:
            if seg.kind == KIND_STALL:
                continue
            bucket = sink[seg.kind]
            bucket[seg.track] = bucket.get(seg.track, 0.0) + seg.seconds
        out.append(StepDecomposition(
            attempt=key, t0=t0, t1=t1, segments=segments,
            compute=compute, wire=wire, codec=codec, stall=stall))
    return out


# ------------------------------------------------------------ aggregation --
def blame(decomps: Sequence[StepDecomposition]) -> List[BlameRow]:
    """Blame table: per (kind, track) critical seconds across all attempts,
    sorted by total critical seconds (the what-if upper bound) descending."""
    n = len(decomps)
    totals: Dict[Tuple[str, str], float] = {}
    steps_on: Dict[Tuple[str, str], int] = {}
    for d in decomps:
        for kind, bucket in ((KIND_COMPUTE, d.compute), (KIND_WIRE, d.wire),
                             (KIND_CODEC, d.codec)):
            for track, secs in bucket.items():
                key = (kind, track)
                totals[key] = totals.get(key, 0.0) + secs
                steps_on[key] = steps_on.get(key, 0) + 1
        if d.stall > 0.0:
            key = (KIND_STALL, "")
            totals[key] = totals.get(key, 0.0) + d.stall
            steps_on[key] = steps_on.get(key, 0) + 1
    grand = sum(totals.values()) or 1.0
    rows = [BlameRow(kind=k, track=t, crit_seconds=v,
                     steps_on_path=steps_on[(k, t)], n_steps=n,
                     mean_seconds=v / n if n else 0.0, share=v / grand)
            for (k, t), v in totals.items()]
    rows.sort(key=lambda r: (-r.crit_seconds, r.kind, r.track))
    return rows


def busy_accounting(events: Iterable[TraceEvent]) -> Dict[str, float]:
    """Total busy seconds per kind over *all* DAG spans (not just critical
    ones) — the quantity that must agree with the simulator's own
    ``SimResult`` accounting (``device_busy`` / ``link_busy`` /
    ``compress_busy`` summed over the traced steps)."""
    out = {KIND_COMPUTE: 0.0, KIND_WIRE: 0.0, KIND_CODEC: 0.0}
    for e in _dag_spans(events):
        out[_CAT_KIND[e.cat]] += e.dur
    return out


def audit(decomps: Sequence[StepDecomposition],
          rel: float = 0.01) -> List[str]:
    """Internal consistency: each attempt's decomposition must cover its
    makespan within ``rel`` — an uncovered remainder means the walker lost
    the chain (a span vocabulary drift, exactly what CI should catch)."""
    problems: List[str] = []
    for d in decomps:
        span = d.makespan
        if span <= 0.0:
            continue
        err = abs(d.total() - span) / span
        if err > rel:
            problems.append(
                f"attempt {d.attempt}: critical-path decomposition covers "
                f"{d.total():.6g}s of a {span:.6g}s makespan "
                f"({err * 100:.2f}% off, budget {rel * 100:.0f}%)")
    return problems


_SIM_BUSY_KEYS = {KIND_COMPUTE: "sim_device_busy_seconds",
                  KIND_WIRE: "sim_link_busy_seconds",
                  KIND_CODEC: "sim_compress_busy_seconds"}


def check_sim_busy(busy: Mapping[str, float], totals: Mapping[str, float],
                   rel: float = 0.01) -> List[str]:
    """Gate the trace-derived busy accounting against the simulator's own
    totals (the ``sim_*_busy_seconds`` counters the ElasticController feeds
    from each step's ``SimResult``).  Returns violation strings."""
    problems: List[str] = []
    for kind, key in _SIM_BUSY_KEYS.items():
        if key not in totals:
            continue
        want = float(totals[key])
        got = float(busy.get(kind, 0.0))
        scale = max(abs(want), abs(got))
        if scale == 0.0:
            continue
        err = abs(got - want) / scale
        if err > rel:
            problems.append(
                f"{kind}: trace busy {got:.6g}s vs sim {key} {want:.6g}s "
                f"({err * 100:.2f}% apart, budget {rel * 100:.0f}%)")
    return problems


# -------------------------------------------------------------- rendering --
def render_blame(rows: Sequence[BlameRow], top: int = 10,
                 width: int = 80) -> str:
    """The blame table, one resource per line, worst first."""
    if not rows:
        return "(no attributable spans in trace)"
    n = rows[0].n_steps
    lines = [f"{'kind':<8} {'track':<14} {'s/step':>10} {'on-path':>8} "
             f"{'share':>7}",
             "-" * min(width, 52)]
    for r in rows[:top]:
        frac = r.steps_on_path / n if n else 0.0
        lines.append(f"{r.kind:<8} {r.track or '-':<14} "
                     f"{r.mean_seconds:>10.4g} {frac * 100:>7.0f}% "
                     f"{r.share * 100:>6.1f}%")
    if len(rows) > top:
        rest = sum(r.crit_seconds for r in rows[top:])
        lines.append(f"... {len(rows) - top} more rows, {rest:.4g}s total")
    return "\n".join(lines)


def to_artifact(decomps: Sequence[StepDecomposition],
                rows: Sequence[BlameRow],
                busy: Mapping[str, float],
                source: str = "",
                extra: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """JSON payload for ``CRITPATH_<name>.json`` (full per-step paths are
    summarized — the blame table is the artifact, the trace is the detail)."""
    payload: Dict[str, Any] = {
        # the JAX package's schema name: both packages write one format
        "schema": "repro.obs/critpath.v1",
        "source": source,
        "n_attempts": len(decomps),
        "blame": [r.to_dict() for r in rows],
        "busy_seconds": dict(busy),
        "attempts": [{k: v for k, v in d.to_dict().items() if k != "path"}
                     for d in decomps],
    }
    if extra:
        payload.update(extra)
    return payload


# -------------------------------------------------------------------- CLI --
def _load(path: str) -> Tuple[List[TraceEvent], Optional[Mapping[str, Any]]]:
    """(events, header) from a recorder JSONL (preferred) or Chrome JSON."""
    if path.endswith(".jsonl"):
        from .export import events_from_dicts, read_header, read_jsonl
        dicts = read_jsonl(path)
        return events_from_dicts(dicts), read_header(dicts)
    from repro_torch.check.traceorder import load_trace_events
    return load_trace_events(path), None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="TRACE .jsonl (recorder) or .json (chrome)")
    ap.add_argument("--top", type=int, default=10,
                    help="blame-table rows to print")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the attribution artifact here")
    ap.add_argument("--expect-busy", default=None, metavar="METRICS",
                    help="metrics-snapshot JSON carrying the simulator's "
                         "sim_*_busy_seconds counters; attribution must "
                         "agree within --busy-tol")
    ap.add_argument("--busy-tol", type=float, default=0.01,
                    help="relative busy-accounting budget (default 1%%)")
    ap.add_argument("--allow-truncated", action="store_true",
                    help="analyze even when the trace header reports "
                         "dropped events (ring-buffer overflow)")
    args = ap.parse_args(argv)

    events, header = _load(args.trace)
    dropped = int((header or {}).get("n_dropped", 0))
    if dropped > 0 and not args.allow_truncated:
        print(f"{args.trace}: REFUSED — header reports {dropped} dropped "
              f"events (ring-buffer overflow); attribution over a truncated "
              f"step would misassign blame.  Re-record with a larger "
              f"TraceRecorder capacity, or pass --allow-truncated.",
              file=sys.stderr)
        return 2

    decomps = analyze(events)
    if not decomps:
        print(f"{args.trace}: no attributable sim spans", file=sys.stderr)
        return 2
    rows = blame(decomps)
    busy = busy_accounting(events)
    print(f"critical path over {len(decomps)} attempt(s), "
          f"mean makespan {sum(d.makespan for d in decomps) / len(decomps):.4g}s")
    print(render_blame(rows, top=args.top))

    problems = audit(decomps, rel=args.busy_tol)
    extra: Dict[str, Any] = {"audit": problems}
    if args.expect_busy:
        with open(args.expect_busy) as f:
            totals = json.load(f)
        sim_problems = check_sim_busy(busy, totals, rel=args.busy_tol)
        problems += sim_problems
        extra["sim_busy_check"] = sim_problems
    if args.json:
        with open(args.json, "w") as f:
            json.dump(to_artifact(decomps, rows, busy, source=args.trace,
                                  extra=extra), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.json}")
    if problems:
        print("ATTRIBUTION GATE FAILED:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"attribution consistent (budget {args.busy_tol * 100:.0f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
