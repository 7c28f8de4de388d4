"""Span-based trace recording (observability spine).

A :class:`TraceRecorder` collects *spans* (begin/end or complete intervals)
and *instant* events into a thread-safe ring buffer.  Two clock domains
coexist in one recorder:

* ``clock="sim"``  — simulated seconds (the discrete-event executor's
  timeline: :func:`repro_torch.core.executor.simulate_iteration` spans, the
  ElasticController's epoch machinery).  Timestamps are supplied by the
  caller in simulated seconds.
* ``clock="wall"`` — host wall-clock via ``time.perf_counter()`` (the real
  RAD executor's stage/compression timings).  Timestamps default to *now*,
  relative to the recorder's construction instant.

Each domain exports as its own Perfetto *process* so the two timelines never
interleave on one track (simulated seconds and wall microseconds share no
origin).  Within a domain, events carry a named *track* (device, link,
controller lane) that export maps to a Perfetto thread.

Categories (the ``cat`` field — what the report CLI groups by)::

    stage.fwd / stage.bwd   pipeline stage compute, one span per micro-batch
    link.transfer           one cross-stage boundary transfer on a wire
    compress.encode/.decode AdaTopK wire encode / decode inside RAD
    migrate.stream          bulk state migration transfers (fore+background)
    checkpoint.restore      state restored out of the broker's store
    controller              epochs, churn events, detector trips, re-plans
    serve.prefill           serving: prompt forward through one stage replica
    serve.replay            serving: KV-prefix replay onto a replacement
                            replica after a mid-session re-route

Profiler spans.  :func:`span` opens a ``torch.profiler.record_function``
range while a ``torch.profiler`` is recording, and nothing otherwise: the
range lands on the profiler's clock, beside the device kernels its body
launches, so a device trace reads device time, launches and idle a span.
:meth:`TraceRecorder.region` enters one around its body as well.  The
training path's spans (their names are what trace readers match)::

    rad.step        DecentralizedRuntime.train_step, the whole call
    rad.fwd.s<i>    stage i's forward (leaf parameters and the stage call)
    rad.bwd.s<i>    stage i's backward (its autograd closure)
    rad.wire        one boundary edge's hand-off, either direction
    attn            attention proper in attn_train (RoPE, mask, sdpa,
                    heads merged; not the projections)
    optim.update    one optimizer update, all leaves

Guarantees the rest of the repo relies on:

* **Disabled ⇒ no-op**: ``TraceRecorder(enabled=False)`` (or passing
  ``trace=None`` to any instrumented function) records nothing and adds no
  measurable work to the hot path — instrumented code must behave
  identically with tracing on or off (pinned in tests).  With no profiler
  recording, :func:`span` builds no ``record_function`` and costs one flag
  read; no span, recorded or profiled, synchronises the device.
* **Deterministic ordering**: every event gets a monotonically increasing
  sequence number; :meth:`events` returns a snapshot sorted by
  ``(clock, ts, seq)``, so two runs of the same simulation produce the same
  event list byte for byte.
* **Bounded memory**: the buffer is a ring (default 2^16 events); the oldest
  spans fall off first and ``n_dropped`` counts them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# ------------------------------------------------------------- categories --
CAT_FWD = "stage.fwd"
CAT_BWD = "stage.bwd"
CAT_TRANSFER = "link.transfer"
CAT_ENCODE = "compress.encode"
CAT_DECODE = "compress.decode"
CAT_MIGRATION = "migrate.stream"
CAT_CHECKPOINT = "checkpoint.restore"
CAT_CONTROLLER = "controller"
CAT_SERVE_PREFILL = "serve.prefill"
CAT_SERVE_REPLAY = "serve.replay"

CATEGORIES = (CAT_FWD, CAT_BWD, CAT_TRANSFER, CAT_ENCODE, CAT_DECODE,
              CAT_MIGRATION, CAT_CHECKPOINT, CAT_CONTROLLER,
              CAT_SERVE_PREFILL, CAT_SERVE_REPLAY)

CLOCK_SIM = "sim"
CLOCK_WALL = "wall"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded event.  ``ts``/``dur`` are *seconds* in the event's clock
    domain; export converts to trace_event microseconds.  ``phase`` follows
    the Chrome convention: ``"X"`` complete span, ``"i"`` instant."""

    seq: int
    clock: str                 # CLOCK_SIM | CLOCK_WALL
    phase: str                 # "X" | "i"
    cat: str
    name: str
    track: str
    ts: float
    dur: float = 0.0
    args: Optional[Mapping[str, Any]] = None

    def shifted(self, dt: float, seq: int,
                extra_args: Optional[Mapping[str, Any]] = None
                ) -> "TraceEvent":
        args = self.args
        if extra_args:
            args = {**(args or {}), **extra_args}
        return dataclasses.replace(self, ts=self.ts + dt, seq=seq, args=args)


class _OpenSpan:
    """Token returned by :meth:`TraceRecorder.begin`; close with ``end``."""

    __slots__ = ("clock", "cat", "name", "track", "ts", "args")

    def __init__(self, clock, cat, name, track, ts, args):
        self.clock = clock
        self.cat = cat
        self.name = name
        self.track = track
        self.ts = ts
        self.args = args


class _NullRegion:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_REGION = _NullRegion()


def span(name: str):
    """A profiler range ``name`` around a ``with`` body while a profiler is
    recording; otherwise the shared no-op region, so that a span costs one
    flag read and builds nothing.  It never synchronises."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL_REGION


class TraceRecorder:
    """Thread-safe ring buffer of spans and instants (see module docstring).

    All recording methods are no-ops when ``enabled=False`` — callers may
    keep a disabled recorder wired through hot paths without cost.
    """

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._n_total = 0
        self._wall0 = time.perf_counter()

    # ------------------------------------------------------------ plumbing --
    def _push(self, clock: str, phase: str, cat: str, name: str, track: str,
              ts: float, dur: float, args) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._n_total += 1
            self._buf.append(TraceEvent(
                seq=seq, clock=clock, phase=phase, cat=cat, name=name,
                track=track, ts=float(ts), dur=float(dur),
                args=dict(args) if args else None))

    def wall_now(self) -> float:
        """Seconds since recorder construction on the wall clock domain."""
        return time.perf_counter() - self._wall0

    # ----------------------------------------------------------- recording --
    def span(self, cat: str, name: str, track: str, t0: float, t1: float,
             args: Optional[Mapping[str, Any]] = None,
             clock: str = CLOCK_SIM) -> None:
        """Record a complete span [t0, t1] (seconds, caller-supplied clock)."""
        if not self.enabled:
            return
        self._push(clock, "X", cat, name, track, t0, max(0.0, t1 - t0), args)

    def instant(self, cat: str, name: str, track: str,
                t: Optional[float] = None,
                args: Optional[Mapping[str, Any]] = None,
                clock: str = CLOCK_SIM) -> None:
        if not self.enabled:
            return
        if t is None:
            t = self.wall_now()
            clock = CLOCK_WALL
        self._push(clock, "i", cat, name, track, t, 0.0, args)

    def begin(self, cat: str, name: str, track: str,
              t: Optional[float] = None,
              args: Optional[Mapping[str, Any]] = None,
              clock: str = CLOCK_SIM) -> Optional[_OpenSpan]:
        """Open a span; pair with :meth:`end`.  ``t=None`` stamps the wall
        clock (the begin/end pair must then stay in the wall domain)."""
        if not self.enabled:
            return None
        if t is None:
            return _OpenSpan(CLOCK_WALL, cat, name, track, self.wall_now(),
                             args)
        return _OpenSpan(clock, cat, name, track, float(t), args)

    def end(self, token: Optional[_OpenSpan], t: Optional[float] = None,
            args: Optional[Mapping[str, Any]] = None) -> None:
        if not self.enabled or token is None:
            return
        t1 = self.wall_now() if t is None else float(t)
        merged = dict(token.args or {})
        if args:
            merged.update(args)
        self._push(token.clock, "X", token.cat, token.name, token.track,
                   token.ts, max(0.0, t1 - token.ts), merged or None)

    def region(self, cat: str, name: str, track: str,
               args: Optional[Mapping[str, Any]] = None):
        """Context manager recording a wall-clock span around its body,
        inside a profiler :func:`span` of the same ``name``."""
        if not self.enabled:
            return span(name)
        return _Region(self, cat, name, track, args)

    def complete_wall(self, cat: str, name: str, track: str, seconds: float,
                      args: Optional[Mapping[str, Any]] = None) -> None:
        """Record a wall-clock span that just finished and took ``seconds``
        (the shape of rad.py's timing callbacks: duration known only at
        completion)."""
        if not self.enabled:
            return
        now = self.wall_now()
        self._push(CLOCK_WALL, "X", cat, name, track,
                   max(0.0, now - seconds), max(0.0, seconds), args)

    def replay(self, events: Iterable[TraceEvent], dt: float,
               extra_args: Optional[Mapping[str, Any]] = None) -> None:
        """Re-emit recorded events shifted by ``dt`` seconds — the
        controller's path for cached per-iteration span sets: the simulator
        runs once per regime, its spans replay every step at the step's
        clock offset."""
        if not self.enabled:
            return
        with self._lock:
            for ev in events:
                seq = self._seq
                self._seq += 1
                self._n_total += 1
                self._buf.append(ev.shifted(dt, seq, extra_args))

    # ------------------------------------------------------------- reading --
    def events(self) -> List[TraceEvent]:
        """Deterministic snapshot: sorted by (clock, ts, seq)."""
        with self._lock:
            snap = list(self._buf)
        return sorted(snap, key=lambda e: (e.clock, e.ts, e.seq))

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def n_dropped(self) -> int:
        with self._lock:
            return self._n_total - len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._n_total = 0
            self._seq = 0


class _Region:
    __slots__ = ("_rec", "_cat", "_name", "_track", "_args", "_t0", "_span")

    def __init__(self, rec, cat, name, track, args):
        self._rec = rec
        self._cat = cat
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        self._span = span(self._name)
        self._span.__enter__()
        self._t0 = self._rec.wall_now()
        return self

    def __exit__(self, *exc):
        self._rec._push(CLOCK_WALL, "X", self._cat, self._name, self._track,
                        self._t0, max(0.0, self._rec.wall_now() - self._t0),
                        self._args)
        self._span.__exit__(*exc)
        return False
