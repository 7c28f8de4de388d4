"""Observability for the port: span tracing, metrics and structured
logging (stdlib only, no-ops when disabled)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .slog import StructuredLogger, add_logging_args, get_logger
from .trace import (CAT_BWD, CAT_CHECKPOINT, CAT_CONTROLLER, CAT_DECODE,
                    CAT_ENCODE, CAT_FWD, CAT_MIGRATION, CAT_SERVE_PREFILL,
                    CAT_SERVE_REPLAY, CAT_TRANSFER, CATEGORIES, CLOCK_SIM,
                    CLOCK_WALL, TraceEvent, TraceRecorder)

__all__ = [
    "CAT_BWD", "CAT_CHECKPOINT", "CAT_CONTROLLER", "CAT_DECODE",
    "CAT_ENCODE", "CAT_FWD", "CAT_MIGRATION", "CAT_SERVE_PREFILL",
    "CAT_SERVE_REPLAY", "CAT_TRANSFER", "CATEGORIES",
    "CLOCK_SIM", "CLOCK_WALL", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "StructuredLogger", "TraceEvent", "TraceRecorder",
    "add_logging_args", "get_logger",
]
