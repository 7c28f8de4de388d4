"""``repro_torch.check`` — the slice of the static plan-verifier the
training path needs: typed findings/errors and the schedule checks that
``schedule_opfence(verify=True)`` runs.  :mod:`.errors` is imported
eagerly (the core IR raises :class:`GraphCheckError` while
``repro_torch.core`` is still initialising); :mod:`.schedule` loads on
first use."""
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
