"""Lightweight metrics registry (counters / gauges / histograms).

No external dependency, no exposition server — just a thread-safe in-process
registry the runtime increments and the run report snapshots.  Metrics are
identified by ``(name, sorted label items)`` so one logical metric fans out
per link / per edge / per cause without pre-registration::

    reg = MetricsRegistry()
    reg.counter("wire_bytes", link="3->5").inc(1.2e6)
    reg.gauge("link_correction", link="3->5").set(2.0)
    reg.histogram("step_seconds").observe(0.41)
    reg.snapshot()   # JSON-ready dict

The glossary the elastic runtime populates (see README §Observability):

* ``wire_bytes{link}``            — counter, bytes on the wire per directed
                                    CompNode link (from LinkTiming telemetry)
* ``link_seconds{link}``          — counter, transport seconds per link
* ``compression_ratio_planned``   — gauge, the plan's requested ratio
* ``compression_ratio_realized``  — gauge, dense bytes / wire bytes actually
                                    achieved by the installed plan
* ``ef_residual_norm{edge}``      — gauge, error-feedback residual L2 norm
* ``replan_count{cause}``         — counter, epoch transitions by cause
* ``detector_trips``              — counter, straggler detector flags
* ``calibration_fits``            — counter, hysteresis-passing fits
* ``rollback_steps``              — counter, steps lost to failures
* ``migrated_bytes{kind}``        — counter, blocking vs background state
* ``step_seconds``                — histogram, simulated per-step wall-clock
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Mapping[str, Any]) -> _Key:
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += float(amount)


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)


class Histogram:
    """Streaming summary: count / sum / min / max plus fixed log-scale
    bucket counts (powers of ``base`` around 1.0) — enough for the report's
    distribution lines without keeping every sample."""

    __slots__ = ("count", "total", "min", "max", "buckets", "base")

    def __init__(self, base: float = 2.0, n_buckets: int = 40):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.base = float(base)
        self.buckets: Dict[int, int] = {}
        del n_buckets  # buckets are sparse; kept for API stability

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = int(math.floor(math.log(v, self.base))) if v > 0 else -10 ** 6
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate ``q``-th percentile (``0 < q <= 100``) from the
        log-scale buckets.

        Error bound: a bucket ``b`` holds samples in ``(base**b,
        base**(b+1)]``; this returns the bucket's upper edge (clamped into
        ``[self.min, self.max]``), so the result is **within one factor of
        ``base`` above** the true sample percentile — e.g. at most 2× with
        the default ``base=2.0``, and within ~1% with ``base=1.01``.
        Non-positive samples share one underflow bucket reported as
        ``min(0.0, self.max)`` clamped the same way."""
        if not 0.0 < q <= 100.0:
            raise ValueError(f"percentile q={q!r} not in (0, 100]")
        if self.count == 0:
            raise ValueError("percentile of an empty histogram")
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= rank:
                edge = 0.0 if b <= -10 ** 6 else self.base ** (b + 1)
                return min(max(edge, self.min), self.max)
        return self.max


class MetricsRegistry:
    """Thread-safe, lazily-populated metric store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[_Key, Any] = {}
        self._kinds: Dict[_Key, str] = {}

    def _get(self, kind: str, factory, name: str, labels: Mapping[str, Any]):
        k = _key(name, labels)
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = self._metrics[k] = factory()
                self._kinds[k] = kind
            elif self._kinds[k] != kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{self._kinds[k]}, not {kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    # ------------------------------------------------------------ reading --
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dict: ``name{k=v,...}`` -> value (counters/gauges) or
        summary dict (histograms).  Deterministic key order."""
        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
        out: Dict[str, Any] = {}
        for (name, labels), m in items:
            label_s = ",".join(f"{k}={v}" for k, v in labels)
            full = f"{name}{{{label_s}}}" if label_s else name
            if kinds[(name, labels)] == "histogram":
                out[full] = {"count": m.count, "sum": m.total,
                             "min": (None if m.count == 0 else m.min),
                             "max": (None if m.count == 0 else m.max),
                             "mean": m.mean}
            else:
                out[full] = m.value
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)
