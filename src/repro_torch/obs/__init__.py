"""Observability for the port: span tracing, metrics, structured logging,
the elastic controller's flight recorder, the telemetry bus and the
watchdog (stdlib only, no-ops when disabled)."""
from .bus import MetricsTelemetrySink, TelemetryBus
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
    "add_logging_args", "get_logger",
]
