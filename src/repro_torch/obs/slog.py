"""Structured logging for the launchers (train / serve / dryrun).

Replaces the launchers' ad-hoc ``print()`` reporting with one consistent
``event key=value ...`` line format routed through the stdlib ``logging``
machinery (so ``--log-level``/``--quiet`` behave as expected), and mirrors
numeric fields into a :class:`repro_torch.obs.metrics.MetricsRegistry` so a
launcher run ends with a queryable metrics snapshot for free::

    log = get_logger("repro_torch.train", metrics=registry)
    log.event("step", step=i, loss=0.42, sps=3.1)
    # -> "step step=10 loss=0.4200 sps=3.100"  (INFO)
    # registry gauge step{field=loss} := 0.42

Numbers are formatted tersely (4 significant decimals for floats); field
order is the caller's keyword order, which keeps related lines aligned and
diffs stable.  ``configure(level)`` installs a stderr handler once —
repeated calls just adjust the level, so libraries can call it safely.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Optional

from .metrics import MetricsRegistry

_CONFIGURED = False
_ROOT = "repro_torch"


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        if v == 0 or 1e-3 <= abs(v) < 1e5:
            return f"{v:.4f}".rstrip("0").rstrip(".") or "0"
        return f"{v:.4g}"
    return str(v)


class _StderrHandler(logging.StreamHandler):
    """StreamHandler that re-reads ``sys.stderr`` at emit time, so capture
    or redirect wrappers installed *after* :func:`configure` (pytest capsys,
    ``contextlib.redirect_stderr``) still receive output."""

    def __init__(self):
        super().__init__(sys.stderr)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):   # base-class ctor assigns; stay late-bound
        pass


def configure(level: str = "info", stream=None) -> None:
    """Install (once) a plain ``message``-only handler on the ``repro_torch``
    logger hierarchy and set its level.  ``level`` accepts the usual names
    plus ``"quiet"`` (alias for warning)."""
    global _CONFIGURED
    name = {"quiet": "warning"}.get(level.lower(), level.lower())
    lvl = getattr(logging, name.upper(), None)
    if not isinstance(lvl, int):
        raise ValueError(f"unknown log level {level!r}")
    logger = logging.getLogger(_ROOT)
    if not _CONFIGURED:
        handler = logging.StreamHandler(stream) if stream is not None \
            else _StderrHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        _CONFIGURED = True
    logger.setLevel(lvl)


class StructuredLogger:
    """Thin wrapper over a stdlib logger emitting ``event k=v`` lines and
    mirroring numeric fields into a metrics registry."""

    def __init__(self, logger: logging.Logger,
                 metrics: Optional[MetricsRegistry] = None):
        self._log = logger
        self.metrics = metrics

    def _mirror(self, event: str, fields) -> None:
        if self.metrics is None:
            return
        for k, v in fields.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.metrics.gauge(event, field=k).set(float(v))

    def _emit(self, level: int, event: str, fields) -> None:
        self._mirror(event, fields)
        if not self._log.isEnabledFor(level):
            return
        parts = [event] + [f"{k}={_fmt_value(v)}" for k, v in fields.items()]
        self._log.log(level, " ".join(parts))

    def event(self, event: str, **fields) -> None:
        self._emit(logging.INFO, event, fields)

    def debug(self, event: str, **fields) -> None:
        self._emit(logging.DEBUG, event, fields)

    def warn(self, event: str, **fields) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit(logging.ERROR, event, fields)


def get_logger(name: str = _ROOT,
               metrics: Optional[MetricsRegistry] = None,
               level: Optional[str] = None) -> StructuredLogger:
    """Structured logger under the ``repro_torch`` hierarchy.  ``level`` (when
    given) also configures the shared handler — the launchers' one-liner:
    ``log = get_logger("repro_torch.train", metrics=reg, level=args.log_level)``.
    """
    if level is not None:
        configure(level)
    elif not _CONFIGURED:
        configure("info")
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return StructuredLogger(logging.getLogger(name), metrics)


def add_logging_args(parser) -> None:
    """Attach the shared ``--log-level`` / ``--quiet`` flags to an
    argparse parser (launcher convention)."""
    parser.add_argument("--log-level", default="info",
                        choices=["debug", "info", "warning", "error"],
                        help="structured-log verbosity")
    parser.add_argument("--quiet", action="store_true",
                        help="alias for --log-level warning")


def level_from_args(args) -> str:
    return "warning" if getattr(args, "quiet", False) else args.log_level
