"""Straggler detection (elastic runtime).

The paper names stragglers as a core challenge of geo-distributed training
(§1) but schedules once and hopes; here the broker keeps watching.  Each
pipeline stage's *measured* per-step time — executor StepTiming samples
aggregated by :class:`repro_torch.elastic.telemetry.TelemetryLog` (median-of-
window, outlier-rejected), never a fresh estimator sweep — is smoothed with
an EWMA and compared to the workload estimator's *prediction* for that
CompNode (:func:`repro_torch.core.estimator.predict_step_times`, the reference
the schedule was built against).  A node whose smoothed time drifts past
``threshold ×`` its prediction is flagged; the controller then degrades the
node's believed λ_p and re-plans, so OP-Fence shifts ops off the straggler
in proportion to the measured slowdown.

Detection delay is explicit: ``min_observations`` steps must accumulate
before a flag fires (on top of the telemetry window's own lag), which the
simulator charges as wall-clock (the cost of noticing, on top of the cost
of migrating).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional


@dataclasses.dataclass
class StageStats:
    """EWMA state for one CompNode's step time."""

    predicted: float
    ewma: Optional[float] = None
    count: int = 0

    def observe(self, seconds: float, alpha: float) -> None:
        self.ewma = seconds if self.ewma is None \
            else alpha * seconds + (1.0 - alpha) * self.ewma
        self.count += 1

    @property
    def severity(self) -> float:
        """Observed/predicted ratio (1.0 = healthy, 4.0 = 4× too slow)."""
        if self.ewma is None or self.predicted <= 0.0:
            return 1.0
        return self.ewma / self.predicted


class StragglerDetector:
    """EWMA drift detector over per-stage step times.

    ``predicted`` maps CompNode index -> expected FP+BP seconds under the
    current schedule (from the estimator).  ``observe`` feeds one step's
    measured per-stage times; ``flagged`` lists nodes whose smoothed time
    exceeds ``threshold ×`` prediction after the warm-up.  ``reset`` installs
    fresh predictions after a re-plan (a new schedule changes every stage's
    expected time, so history must not carry over).
    """

    def __init__(self, predicted: Mapping[int, float],
                 alpha: float = 0.4, threshold: float = 1.8,
                 min_observations: int = 3):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha in (0, 1]")
        if threshold <= 1.0:
            raise ValueError("threshold must exceed 1.0")
        self.alpha = alpha
        self.threshold = threshold
        self.min_observations = int(min_observations)
        self.stats: Dict[int, StageStats] = {}
        self.reset(predicted)

    def reset(self, predicted: Mapping[int, float]) -> None:
        self.stats = {int(d): StageStats(predicted=float(t))
                      for d, t in predicted.items()}

    def reprice(self, predicted: Mapping[int, float]) -> None:
        """Install recalibrated reference predictions *without* dropping the
        EWMA observation history.  Used by closed-loop link calibration: the
        schedule (hence the observation stream) did not change, only the
        broker's cost model for it — a ``reset`` here would grant a genuine
        straggler a fresh ``min_observations`` warm-up every calibration
        window and let it hide indefinitely."""
        for d, t in predicted.items():
            st = self.stats.get(int(d))
            if st is None:
                self.stats[int(d)] = StageStats(predicted=float(t))
            else:
                st.predicted = float(t)

    def observe(self, stage_times: Mapping[int, float]) -> None:
        for d, t in stage_times.items():
            st = self.stats.get(int(d))
            if st is not None:
                st.observe(float(t), self.alpha)

    def flagged(self) -> List[int]:
        return sorted(d for d, st in self.stats.items()
                      if st.count >= self.min_observations
                      and st.severity > self.threshold)

    def severity(self, node: int) -> float:
        st = self.stats.get(int(node))
        return st.severity if st is not None else 1.0

    def believed_factors(self) -> Dict[int, float]:
        """Per-flagged-node speed factor (1/severity) — what the controller
        folds into the believed ClusterSpec before re-planning, so the DP
        split sizes segments against the node's *measured* pace."""
        return {d: 1.0 / self.severity(d) for d in self.flagged()}
