"""Telemetry event bus: one emission stream, many subscribers.

PRs 2–4 wired executors straight into the broker's
:class:`repro_torch.elastic.telemetry.TelemetryLog`.  The observability layer
wants the *same* StepTiming/LinkTiming stream (for per-link wire-byte
metrics, trace instants, user sinks) without the executor knowing who
listens — so the stream becomes a bus.  Anything implementing the
``TelemetrySink`` protocol (``record(StepTiming)`` and optionally
``record_link(LinkTiming)`` / ``record_kernel(KernelTiming)``) subscribes;
the bus itself implements the protocol, so it drops in wherever a sink was
passed before.

Parity contract (tested): a TelemetryLog fed through the bus reports
bit-identical ``node_step_times()`` / ``link_samples()`` to one fed
directly — the bus adds fan-out, never transformation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional

from .metrics import MetricsRegistry


class TelemetryBus:
    """Fan-out for StepTiming / LinkTiming samples.

    Subscribers are notified in subscription order (deterministic).  A
    subscriber without ``record_link`` simply never sees link samples —
    mirroring how executors probe sinks today.
    """

    def __init__(self, subscribers: Iterable[Any] = ()):
        self._subs: List[Any] = []
        for s in subscribers:
            self.subscribe(s)

    def subscribe(self, sink: Any) -> None:
        if not hasattr(sink, "record"):
            raise TypeError(f"{sink!r} lacks record(StepTiming)")
        self._subs.append(sink)

    @property
    def subscribers(self) -> List[Any]:
        return list(self._subs)

    # ------------------------------------------------- TelemetrySink protocol
    def record(self, sample) -> None:
        for s in self._subs:
            s.record(sample)

    def record_link(self, sample) -> None:
        for s in self._subs:
            rl = getattr(s, "record_link", None)
            if rl is not None:
                rl(sample)

    def record_kernel(self, sample) -> None:
        for s in self._subs:
            rk = getattr(s, "record_kernel", None)
            if rk is not None:
                rk(sample)

    # ------------------------------------------------- bulk (controller path)
    def record_step(self, samples: Iterable[Any], step: int) -> None:
        for s in samples:
            self.record(dataclasses.replace(s, step=step))

    def record_link_step(self, samples: Iterable[Any], step: int) -> None:
        for s in samples:
            self.record_link(dataclasses.replace(s, step=step))

    def record_kernel_step(self, samples: Iterable[Any], step: int) -> None:
        for s in samples:
            self.record_kernel(dataclasses.replace(s, step=step))


class MetricsTelemetrySink:
    """Bus subscriber that folds the telemetry stream into a
    :class:`repro_torch.obs.metrics.MetricsRegistry`:

    * ``wire_bytes{link=i->j}`` / ``link_seconds{link=i->j}`` counters per
      directed link (the "bytes on wire per link" metric);
    * ``stage_compute_seconds{node}`` / ``stage_comm_seconds{node}``
      counters per CompNode.
    """

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics

    def record(self, sample) -> None:
        node = int(sample.node)
        self.metrics.counter("stage_compute_seconds", node=node).inc(
            float(sample.compute_seconds))
        if sample.comm_seconds:
            self.metrics.counter("stage_comm_seconds", node=node).inc(
                float(sample.comm_seconds))

    def record_link(self, sample) -> None:
        link = f"{int(sample.src)}->{int(sample.dst)}"
        self.metrics.counter("wire_bytes", link=link).inc(
            float(sample.nbytes))
        self.metrics.counter("link_seconds", link=link).inc(
            float(sample.seconds))
