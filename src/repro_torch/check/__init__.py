"""``repro_torch.check`` — static plan-verifier for the OP-DAG planning
stack.

One entry point per planning artifact, each returning typed
:class:`Finding` lists (``check_*``) or raising the matching
:class:`CheckError` subclass (``verify_*``):

=================  ========================================================
artifact           entry points
=================  ========================================================
OP-DAG + profiles  :func:`check_graph`, :func:`check_profiles`,
                   :func:`verify_graph`
schedule           :func:`check_schedule`, :func:`verify_schedule`
cost model         :func:`check_cost_model`, :func:`verify_cost_model`
compression plan   :func:`check_compression_plan`, :func:`verify_plan`
elastic re-plan    :func:`check_moves`, :func:`check_pinned_moves`,
                   :func:`check_replan`, :func:`verify_replan`
span traces        :func:`check_trace_order`, :func:`verify_trace`,
                   :func:`load_trace_events`
bench baselines    :func:`check_bench_result`, :func:`verify_bench_result`
repo conventions   :func:`lint_tree`, :func:`lint_source`,
                   :func:`verify_lint`
=================  ========================================================

The planners (``schedule_opfence`` / ``schedule_joint``) and the
``ElasticController`` call the verifiers on every plan they install;
pass ``verify=False`` to opt out.  CLI: ``python -m repro_torch.check``.

Only :mod:`repro_torch.check.errors` is imported eagerly — the core IR
raises :class:`GraphCheckError` at graph-construction time, so this
package must be importable while ``repro_torch.core`` is still
initialising.  Every checker module loads lazily on first attribute
access (PEP 562).
"""
from __future__ import annotations

from .errors import (BaselineCheckError, CheckError, CompressionCheckError,
                     CostCheckError, ElasticCheckError, Finding,
                     GraphCheckError, ScheduleCheckError, SEV_ERROR,
                     SEV_WARN, TraceOrderError, errors_only, fmt_findings,
                     raise_findings)

_LAZY = {
    "check_graph": "graph", "check_profiles": "graph",
    "verify_graph": "graph",
    "check_schedule": "schedule", "verify_schedule": "schedule",
    "check_cost_model": "costs", "verify_cost_model": "costs",
    "check_compression_plan": "costs", "verify_plan": "costs",
    "check_moves": "elastic", "check_pinned_moves": "elastic",
    "check_replan": "elastic", "verify_replan": "elastic",
    "check_trace_order": "traceorder", "verify_trace": "traceorder",
    "load_trace_events": "traceorder",
    "check_bench_result": "bench", "verify_bench_result": "bench",
    "lint_tree": "lint", "lint_source": "lint", "verify_lint": "lint",
    "LintError": "lint",
}

__all__ = [
    "BaselineCheckError", "CheckError", "CompressionCheckError",
    "CostCheckError", "ElasticCheckError", "Finding", "GraphCheckError",
    "ScheduleCheckError", "SEV_ERROR", "SEV_WARN", "TraceOrderError",
    "errors_only", "fmt_findings", "raise_findings",
] + sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
