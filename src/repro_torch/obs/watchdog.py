"""Streaming SLO and anomaly watchdogs over the telemetry stream.

The elastic controller's own straggler detector is deliberately slow to act:
it windows telemetry, MAD-filters it, waits for calibration hysteresis, and
only then re-plans.  That is the right speed for *acting* (re-plans cost
migration bytes) but the wrong speed for *knowing*.  A :class:`Watchdog` is
the knowing half: a cheap streaming monitor that flags a regime shift on the
first degraded sample, emits a typed
:class:`~repro_torch.obs.record.WatchdogRecord` into the
:class:`~repro_torch.obs.record.FlightRecorder`, a ``slog`` warning, and a
``watchdog_trips`` metric — so the flight log shows *when the symptom
started*, steps before the controller's ``replan`` record shows when the
cure was applied (asserted in the churn acceptance test).

Three rule families:

* **SLO rules** — hard bounds the operator states up front: step-time p99
  (``step_slo_p99``, checked against the streaming
  :meth:`~repro_torch.obs.metrics.Histogram.percentile` once warm) and a serving
  tokens/s floor (``tokens_floor``).
* **EWMA anomaly** — exponentially weighted mean/variance per signal; a
  sample ``k`` standard deviations above the mean trips.  Deterministic
  sims have near-zero variance, so the std is floored at ``rel_floor`` of
  the mean: a trip therefore means "moved more than ~``k * rel_floor``
  relative to steady state", not "moved at all".
* **MAD anomaly** — median/MAD over a sliding window, robust to the level
  shifts EWMA absorbs; same relative floor.

The watchdog speaks the :class:`~repro_torch.obs.bus.TelemetryBus` sink protocol
(``record`` / ``record_link``), so subscribing it to the controller's bus
gives per-stage and per-link coverage — a per-link EWMA *names* the degraded
wire in its record, the same label the blame table and the calibrator use.

Trips de-duplicate per ``(rule, signal)`` with a ``holdoff`` of observations
so one regime shift logs one record, not one per step, while still re-arming
after the holdoff in case the shift worsens.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from .metrics import Histogram, MetricsRegistry
from .record import FlightRecorder, WatchdogRecord
from .slog import StructuredLogger, get_logger

# Relative std/MAD floor: deterministic replay has zero variance, and a
# zero-width reference band would trip on any float jitter.  2% of the
# running mean means "a trip is a >~8% move" at the default k.
_REL_FLOOR = 0.02


class _Ewma:
    """Streaming mean/variance (exponentially weighted), tested *before*
    updating so the sample that breaks the regime is judged against the old
    regime."""

    __slots__ = ("alpha", "k", "rel_floor", "warmup", "n", "mean", "var")

    def __init__(self, alpha: float = 0.3, k: float = 4.0,
                 rel_floor: float = _REL_FLOOR, warmup: int = 3):
        self.alpha = float(alpha)
        self.k = float(k)
        self.rel_floor = float(rel_floor)
        self.warmup = int(warmup)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def observe(self, x: float) -> Optional[float]:
        """Returns the violated reference (the EWMA mean) if ``x`` trips."""
        trip: Optional[float] = None
        if self.n >= self.warmup:
            std = max(math.sqrt(self.var), self.rel_floor * abs(self.mean))
            if abs(x - self.mean) > self.k * std:
                trip = self.mean
        if self.n == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        return trip


class _MadWindow:
    """Median/MAD over a sliding window, tested before the sample enters
    the window."""

    __slots__ = ("window", "k", "rel_floor", "warmup", "buf")

    def __init__(self, window: int = 16, k: float = 3.5,
                 rel_floor: float = _REL_FLOOR, warmup: int = 3):
        self.window = int(window)
        self.k = float(k)
        self.rel_floor = float(rel_floor)
        self.warmup = int(warmup)
        self.buf: Deque[float] = deque(maxlen=self.window)

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def observe(self, x: float) -> Optional[float]:
        trip: Optional[float] = None
        if len(self.buf) >= self.warmup:
            med = self._median(list(self.buf))
            mad = self._median([abs(v - med) for v in self.buf])
            scale = max(1.4826 * mad, self.rel_floor * abs(med))
            if abs(x - med) > self.k * scale:
                trip = med
        self.buf.append(x)
        return trip


class Watchdog:
    """Streaming SLO/anomaly monitor emitting typed flight records.

    Feed it explicitly (:meth:`observe_step`, :meth:`observe_tokens`) or
    subscribe it to a :class:`~repro_torch.obs.bus.TelemetryBus` (it implements
    ``record`` / ``record_link``).  ``step_slo_p99`` / ``tokens_floor`` are
    optional hard SLOs; anomaly detection always runs.
    """

    def __init__(self,
                 flight: Optional[FlightRecorder] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 log: Optional[StructuredLogger] = None,
                 step_slo_p99: Optional[float] = None,
                 tokens_floor: Optional[float] = None,
                 k: float = 4.0,
                 rel_floor: float = _REL_FLOOR,
                 warmup: int = 3,
                 holdoff: int = 8):
        self.flight = flight
        self.metrics = metrics
        self.log = log if log is not None else get_logger("repro_torch.watchdog")
        self.step_slo_p99 = step_slo_p99
        self.tokens_floor = tokens_floor
        self.k = float(k)
        self.rel_floor = float(rel_floor)
        self.warmup = int(warmup)
        self.holdoff = int(holdoff)
        self.records: List[WatchdogRecord] = []
        self._ewma: Dict[str, _Ewma] = {}
        self._mad: Dict[str, _MadWindow] = {}
        self._p99 = Histogram(base=1.01)  # ~1% streaming percentile error
        self._last_trip: Dict[tuple, int] = {}
        self._seen: Dict[str, int] = {}
        # context stamped onto bus-fed records (the controller sets these
        # via observe_step; raw bus samples carry only the step)
        self._clock = 0.0

    # ----------------------------------------------------------- plumbing --
    def _trip(self, rule: str, signal: str, step: int, clock: float,
              value: float, reference: float, message: str = "") -> None:
        n = self._seen.get(signal, 0)
        key = (rule, signal)
        last = self._last_trip.get(key)
        if last is not None and n - last < self.holdoff:
            return
        self._last_trip[key] = n
        denom = abs(reference) if reference else 1.0
        rec = WatchdogRecord(step=int(step), clock=float(clock), rule=rule,
                             signal=signal, value=float(value),
                             reference=float(reference),
                             severity=abs(value - reference) / denom,
                             message=message)
        self.records.append(rec)
        if self.flight is not None:
            self.flight.log(rec)
        if self.metrics is not None:
            self.metrics.counter("watchdog_trips", rule=rule,
                                 signal=signal).inc()
        self.log.warn("watchdog", rule=rule, signal=signal, step=int(step),
                      value=float(value), reference=float(reference),
                      severity=rec.severity)

    def _anomaly(self, signal: str, step: int, clock: float,
                 value: float, low_is_bad: bool = False) -> None:
        """Run both streaming detectors on one (signal, value) sample."""
        self._seen[signal] = self._seen.get(signal, 0) + 1
        ew = self._ewma.get(signal)
        if ew is None:
            ew = self._ewma[signal] = _Ewma(k=self.k,
                                            rel_floor=self.rel_floor,
                                            warmup=self.warmup)
        md = self._mad.get(signal)
        if md is None:
            md = self._mad[signal] = _MadWindow(k=self.k,
                                               rel_floor=self.rel_floor,
                                               warmup=self.warmup)
        ref = ew.observe(value)
        if ref is not None and (low_is_bad or value > ref):
            self._trip("ewma", signal, step, clock, value, ref)
        ref = md.observe(value)
        if ref is not None and (low_is_bad or value > ref):
            self._trip("mad", signal, step, clock, value, ref)

    # --------------------------------------------------------- entrypoints --
    def observe_step(self, step: int, clock: float, seconds: float) -> None:
        """One training step took ``seconds`` of simulated time."""
        self._clock = float(clock)
        self._anomaly("step_seconds", step, clock, float(seconds))
        self._p99.observe(float(seconds))
        if self.step_slo_p99 is not None and self._p99.count >= self.warmup:
            p99 = self._p99.percentile(99.0)
            if p99 > self.step_slo_p99:
                self._trip("slo", "step_seconds_p99", step, clock, p99,
                           self.step_slo_p99,
                           message="step-time p99 SLO violated")

    def observe_link(self, step: int, clock: float, src: int, dst: int,
                     seconds: float) -> None:
        """One transfer on the directed link ``src -> dst``."""
        self._anomaly(f"link {int(src)}->{int(dst)}", step, clock,
                      float(seconds))

    def observe_tokens(self, step: int, clock: float,
                       tokens_per_s: float) -> None:
        """One serving round's aggregate decode rate."""
        self._clock = float(clock)
        rate = float(tokens_per_s)
        if self.tokens_floor is not None:
            sig = "tokens_per_s"
            self._seen[sig] = self._seen.get(sig, 0) + 1
            if rate < self.tokens_floor:
                self._trip("slo", sig, step, clock, rate, self.tokens_floor,
                           message="serving tokens/s floor violated")
        # invert: a *drop* in throughput is the anomaly
        self._anomaly("tokens_per_s_dip", step, clock, -rate,
                      low_is_bad=False)

    # ------------------------------------------- TelemetrySink protocol --
    def record(self, sample: Any) -> None:
        """Bus hook for :class:`~repro_torch.core.executor.StepTiming` samples:
        watches each stage's total seconds."""
        self._anomaly(f"stage{int(sample.node)}_seconds",
                      int(getattr(sample, "step", 0)), self._clock,
                      float(sample.compute_seconds)
                      + float(getattr(sample, "comm_seconds", 0.0)))

    def record_link(self, sample: Any) -> None:
        """Bus hook for :class:`~repro_torch.core.executor.LinkTiming` samples:
        per-link anomaly detection normalized to seconds-per-byte so
        micro-batch size changes don't masquerade as link shifts."""
        nbytes = float(getattr(sample, "nbytes", 0.0))
        if nbytes <= 0.0:
            return
        self._anomaly(f"link {int(sample.src)}->{int(sample.dst)}",
                      int(getattr(sample, "step", 0)), self._clock,
                      float(sample.seconds) / nbytes)

    # -------------------------------------------------------------- query --
    def first_trip(self, rule: Optional[str] = None,
                   signal_prefix: str = "") -> Optional[WatchdogRecord]:
        """Earliest trip (optionally filtered), or ``None``."""
        for rec in self.records:
            if rule is not None and rec.rule != rule:
                continue
            if signal_prefix and not rec.signal.startswith(signal_prefix):
                continue
            return rec
        return None
