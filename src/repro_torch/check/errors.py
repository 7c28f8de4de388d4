"""Typed findings + error hierarchy for the static plan-verifier.

Every checker in :mod:`repro_torch.check` returns a list of :class:`Finding`
records — one per violated invariant, each naming the artifact element
(op, edge, device, track, metric) it indicts — and each ``verify_*``
wrapper raises the matching :class:`CheckError` subclass when any
error-severity finding survives.

This module is import-light on purpose (stdlib + dataclasses only): the
core IR (:mod:`repro_torch.core.opgraph`) raises :class:`GraphCheckError` at
graph-construction time, so nothing here may import back into
``repro_torch.core`` / ``repro_torch.elastic``.  All error types subclass
:class:`ValueError` — call sites that predate the typed hierarchy keep
catching what they always caught.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

SEV_ERROR = "error"
SEV_WARN = "warn"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``code`` is a stable kebab-case identifier (tests and CI key on it);
    ``where`` names the offending element — an op, an ``a->b`` edge, a
    ``dev3`` device, a trace track, a ``system.metric`` pair; ``message``
    is the human-readable explanation.
    """

    code: str
    where: str
    message: str
    severity: str = SEV_ERROR

    def __str__(self) -> str:
        tag = "" if self.severity == SEV_ERROR else f" [{self.severity}]"
        return f"{self.code} @ {self.where}: {self.message}{tag}"


def errors_only(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEV_ERROR]


class CheckError(ValueError):
    """Base of the typed check hierarchy; carries its findings."""

    def __init__(self, message: str = "",
                 findings: Sequence[Finding] = ()):
        self.findings: Tuple[Finding, ...] = tuple(findings)
        if not message:
            message = "; ".join(str(f) for f in self.findings) \
                or "check failed"
        elif self.findings:
            message = message + ": " + \
                "; ".join(str(f) for f in self.findings)
        super().__init__(message)

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(f.code for f in self.findings)


class GraphCheckError(CheckError):
    """OP-DAG structural invariant violated (cycle, dangling dep,
    duplicate name, shape inconsistency, unreachable op)."""


class ScheduleCheckError(CheckError):
    """Schedule invariant violated (coverage, contiguity, membership,
    capacity)."""


class CostCheckError(CheckError):
    """EdgeCostModel self-consistency violated (underivable bytes,
    wire inflation, out-of-clamp correction, missing link)."""


class CompressionCheckError(CheckError):
    """AdaTopK plan invariant violated (ratio below break-even, wire
    inflation, unknown encoding/op)."""


class ElasticCheckError(CheckError):
    """Re-plan invariant violated (candidate misses ops, non-conserving
    move-set, pinned boundary crossed)."""


class TraceOrderError(CheckError):
    """Happens-before violated in a span log (overlapping sends on one
    link, compute before its inbound transfer, non-monotonic track)."""


class BaselineCheckError(CheckError):
    """Committed bench baseline malformed (truncated, non-numeric,
    no tracked metric)."""


def raise_findings(findings: Sequence[Finding], exc_type=CheckError,
                   context: str = "",
                   strict: bool = False) -> List[Finding]:
    """Raise ``exc_type`` when any error-severity finding is present
    (``strict=True`` also promotes warnings).  Returns the findings when
    nothing raises, so verify wrappers can hand survivors back."""
    bad = list(findings) if strict else errors_only(findings)
    if bad:
        raise exc_type(context, findings=bad)
    return list(findings)


def fmt_findings(findings: Sequence[Finding],
                 header: Optional[str] = None) -> str:
    lines = [header] if header else []
    lines += [f"  - {f}" for f in findings]
    return "\n".join(lines)
