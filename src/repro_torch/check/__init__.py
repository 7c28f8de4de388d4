"""``repro_torch.check`` — the slice of the static plan-verifier the
training path and the elastic runtime need: typed findings/errors, the
schedule checks that ``schedule_opfence(verify=True)`` runs, the
compression-plan and cost-model checks (:mod:`.costs`, run by
``schedule_joint`` and the controller) and the re-plan checks
(:mod:`.elastic`, run by ``replan``).  :mod:`.errors` is imported eagerly
(the core IR raises :class:`GraphCheckError` while ``repro_torch.core`` is
still initialising); the checker modules load on first use."""
from __future__ import annotations

from .errors import (BaselineCheckError, CheckError, CompressionCheckError,
                     CostCheckError, ElasticCheckError, Finding,
                     GraphCheckError, ScheduleCheckError, SEV_ERROR,
                     SEV_WARN, TraceOrderError, errors_only, fmt_findings,
                     raise_findings)

__all__ = [
    "BaselineCheckError", "CheckError", "CompressionCheckError",
    "CostCheckError", "ElasticCheckError", "Finding", "GraphCheckError",
    "ScheduleCheckError", "SEV_ERROR", "SEV_WARN", "TraceOrderError",
    "errors_only", "fmt_findings", "raise_findings",
]
