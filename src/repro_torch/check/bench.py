"""Bench-result / committed-baseline schema checks.

``benchmarks/compare.py`` gates CI on
``benchmarks/baselines/BENCH_baseline_joint.json``; a hand-edited or
truncated baseline must fail loudly instead of silently gating against
garbage.  :func:`check_bench_result` accepts either the envelope shape
(``{"result": {...}, ...}``) or a bare ``{system: {metric: value}}``
mapping and verifies:

* the result is a non-empty mapping of non-empty per-system mappings,
* every metric value is a finite number,
* every *tracked* metric (the ones the perf gate keys on) is > 0, and
  at least one system actually carries one — a baseline with no tracked
  metric would make the gate vacuously pass.
"""
from __future__ import annotations

import math
from typing import Any, List, Mapping, Sequence, Tuple

from .errors import BaselineCheckError, Finding, raise_findings

TRACKED_DEFAULT: Tuple[str, ...] = ("pace", "phi")


def check_bench_result(payload: Any,
                       tracked: Sequence[str] = TRACKED_DEFAULT,
                       source: str = "") -> List[Finding]:
    where = source or "<payload>"
    if not isinstance(payload, Mapping):
        return [Finding("not-a-mapping", where,
                        f"bench payload is {type(payload).__name__}, "
                        "expected a JSON object")]
    result = payload.get("result", payload)
    if not isinstance(result, Mapping) or not result:
        return [Finding("empty-result", where,
                        "no per-system results (truncated baseline?)")]
    out: List[Finding] = []
    seen_tracked = False
    for system, metrics in result.items():
        sw = f"{where}:{system}"
        if not isinstance(metrics, Mapping):
            # scalar harness annotations (wall_seconds, notes) ride along
            # at system level; the gate skips them, so does the schema —
            # unless they are something structurally wrong
            if not isinstance(metrics, (int, float, str)) \
                    or isinstance(metrics, bool):
                out.append(Finding("bad-system", sw,
                                   f"system {system!r} carries "
                                   f"{metrics!r}, expected a metric mapping "
                                   "or a scalar annotation"))
            continue
        if not metrics:
            out.append(Finding("bad-system", sw,
                               f"system {system!r} carries an empty metric "
                               "mapping (truncated baseline?)"))
            continue
        for metric, v in metrics.items():
            mw = f"{sw}.{metric}"
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                out.append(Finding("non-numeric-metric", mw,
                                   f"{system}.{metric} = {v!r} is not a "
                                   "number"))
                continue
            if not math.isfinite(v):
                out.append(Finding("non-finite-metric", mw,
                                   f"{system}.{metric} = {v!r}"))
                continue
            if metric in tracked:
                seen_tracked = True
                if v <= 0:
                    out.append(Finding(
                        "bad-tracked-metric", mw,
                        f"tracked metric {system}.{metric} = {v!r} must "
                        "be > 0 for ratio gating"))
    if not seen_tracked:
        out.append(Finding(
            "no-tracked-metric", where,
            f"no system carries any tracked metric {tuple(tracked)!r} — "
            "the perf gate would vacuously pass"))
    return out


def verify_bench_result(payload: Any,
                        tracked: Sequence[str] = TRACKED_DEFAULT,
                        source: str = "",
                        strict: bool = False) -> List[Finding]:
    findings = check_bench_result(payload, tracked=tracked, source=source)
    return raise_findings(
        findings, BaselineCheckError,
        f"bench baseline {source or '<payload>'} failed validation",
        strict=strict)
