"""Observability for the port: span tracing, metrics, structured logging,
the elastic controller's flight recorder, the telemetry bus, the watchdog
and the trace export (Chrome/Perfetto JSON, JSONL) — stdlib only, no-ops
when disabled — and the profiler spans of the training path
(:func:`repro_torch.obs.trace.span`, torch's ``record_function`` while a
profiler records).

Three analysis modules read what these record, and are imported
explicitly, not re-exported (they pull in :mod:`repro_torch.check` and
:mod:`repro_torch.core` lazily):

* :mod:`repro_torch.obs.critpath` — critical-path bottleneck attribution
  over span logs (the blame table, the busy accounting and its gate);
* :mod:`repro_torch.obs.whatif` — counterfactual re-pricing of a recorded
  step through the simulator;
* :mod:`repro_torch.obs.report` — the run-report CLI rendering timeline,
  overlap, straggler heatmap, critical path and decision log from the
  artifacts.
"""
from .bus import MetricsTelemetrySink, TelemetryBus
from .export import (events_from_dicts, read_header, read_jsonl,
                     surface_drops, to_trace_events, validate_trace_events,
                     write_chrome_trace, write_jsonl)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .record import (CalibrationRecord, CandidateScore, DetectorRecord,
                     EpochFlightRecord, FlightRecorder, ReplanRecord,
                     RouteRecord, WatchdogRecord)
from .slog import StructuredLogger, add_logging_args, get_logger
from .watchdog import Watchdog
from .trace import (CAT_BWD, CAT_CHECKPOINT, CAT_CONTROLLER, CAT_DECODE,
                    CAT_ENCODE, CAT_FWD, CAT_MIGRATION, CAT_SERVE_PREFILL,
                    CAT_SERVE_REPLAY, CAT_TRANSFER, CATEGORIES, CLOCK_SIM,
                    CLOCK_WALL, TraceEvent, TraceRecorder)

__all__ = [
    "CAT_BWD", "CAT_CHECKPOINT", "CAT_CONTROLLER", "CAT_DECODE",
    "CAT_ENCODE", "CAT_FWD", "CAT_MIGRATION", "CAT_SERVE_PREFILL",
    "CAT_SERVE_REPLAY", "CAT_TRANSFER", "CATEGORIES",
    "CLOCK_SIM", "CLOCK_WALL", "CalibrationRecord", "CandidateScore",
    "Counter", "DetectorRecord", "EpochFlightRecord", "FlightRecorder",
    "Gauge", "Histogram", "MetricsRegistry", "MetricsTelemetrySink",
    "ReplanRecord", "RouteRecord", "StructuredLogger", "TelemetryBus",
    "TraceEvent", "TraceRecorder", "Watchdog", "WatchdogRecord",
    "add_logging_args", "events_from_dicts", "get_logger", "read_header",
    "read_jsonl", "surface_drops", "to_trace_events", "validate_trace_events",
    "write_chrome_trace", "write_jsonl",
]
