"""Broker-side timing telemetry (elastic runtime).

A straggler detector fed ``predict_step_times`` evaluated on the
*ground-truth* cluster would observe the broker's own estimator, not the
system.  This module closes the loop on measured pace: the executors emit
per-stage, per-micro-batch :class:`repro_torch.core.executor.StepTiming` samples
(`simulate_iteration` stamps simulated seconds; ``DecentralizedRuntime``
stamps measured host wall-clock), and the broker's :class:`TelemetryLog`
aggregates them into the per-CompNode step times that
:meth:`repro_torch.elastic.detector.StragglerDetector.observe` consumes.

Aggregation is deliberately robust, because real volunteer timings are
noisy (GC pauses, page faults, transient congestion):

* per step, a node's samples are folded into one FP+BP seconds value per
  micro-batch (``Σ samples / n_micro`` — the unit ``predict_step_times``
  predicts);
* across the last ``window`` steps, outliers are rejected by the
  median-absolute-deviation rule (|x − median| > k·MAD) and the median of
  the survivors is reported.

A single spiked step therefore cannot flag a healthy node (tested), while a
genuine slowdown shifts the whole window and surfaces within ``window``
steps.  ``predict_step_times`` remains the detector's reference *prediction*
only — the observation path is telemetry, end to end.

Beyond node step times, the log also aggregates **per-link** transfer
observations (:class:`repro_torch.core.executor.LinkTiming`): per step, each
directed CompNode pair's transfers fold into one ``(bytes, seconds)`` total,
and :meth:`TelemetryLog.link_samples` reports the MAD-filtered window of
those totals — the exact input
:func:`repro_torch.core.costmodel.fit_link_corrections` needs to calibrate the
planner's α–β model against the wire the traffic actually rode.  That is the
observation half of the closed planning loop; the controller owns the fit,
hysteresis, and re-plan trigger.

The same machinery carries **per-device codec** observations
(:class:`repro_torch.core.executor.KernelTiming`): per step, each device's encode
invocations fold into one ``(dense_bytes, seconds)`` total, and
:meth:`TelemetryLog.kernel_samples` reports the MAD-filtered window of
per-invocation means — the input
:func:`repro_torch.core.costmodel.fit_kernel_costs` needs to price
``EdgeCostModel.compress_seconds`` from what the kernels actually cost on
this host, closing the planner's encode-vs-wire profitability loop.

Since the observability layer landed, ``TelemetryLog`` is one subscriber on
the controller's :class:`repro_torch.obs.bus.TelemetryBus` rather than the sole
consumer of executor samples: the bus fans each ``StepTiming``/``LinkTiming``
out to every subscriber (this log, the metrics registry sink, …) with
per-sample semantics identical to feeding the log directly — bus-fed and
direct-fed logs agree bit for bit (tested).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.executor import KernelTiming, LinkTiming, StepTiming


def _robust_window_stat(values: Sequence[float], mad_k: float) -> float:
    """Median of the window after MAD outlier rejection.

    With < 3 samples there is nothing to reject against — return the plain
    median.  MAD of 0 (constant window) keeps only exact-median samples,
    which is the correct degenerate behaviour: one spike in an otherwise
    constant window is rejected outright.
    """
    x = np.asarray(values, dtype=np.float64)
    if x.size < 3:
        return float(np.median(x))
    med = float(np.median(x))
    mad = float(np.median(np.abs(x - med)))
    keep = np.abs(x - med) <= mad_k * mad
    if not np.any(keep):
        return med
    return float(np.median(x[keep]))


@dataclasses.dataclass
class _NodeSeries:
    """Per-node history: one aggregated seconds value per observed step."""

    steps: List[int] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _KernelSeries:
    """Per-device codec history: per observed step, the total dense payload
    bytes the device's encode kernels read, the total seconds they took, and
    the invocation count.  As with links, the calibration pair reported per
    step is the per-invocation *mean* ``(B/K, S/K)`` — exact under the
    affine ``α + dense_bytes/bw`` kernel cost model."""

    steps: List[int] = dataclasses.field(default_factory=list)
    nbytes: List[float] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)
    counts: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _LinkSeries:
    """Per-directed-link history: per observed step, the total wire bytes the
    link carried, the total transport seconds they took, and the number of
    transfers folded in.  The count matters: K transfers pay K α's, so the
    calibration pair reported per step is the *mean* transfer ``(B/K, S/K)``
    — exact under the affine α–β model (``Σ(α+β·bₖ)/K = α + β·(Σbₖ/K)``),
    whereas the raw total would inflate every healthy link by (K−1)·α."""

    steps: List[int] = dataclasses.field(default_factory=list)
    nbytes: List[float] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)
    counts: List[int] = dataclasses.field(default_factory=list)


class TelemetryLog:
    """Sliding-window aggregator from raw StepTiming samples to the
    per-CompNode step times the straggler detector observes.

    ``record`` accepts samples in any order within a step; ``node_step_times``
    reports, per node, the robust (median-of-window, MAD outlier-rejected)
    per-micro-batch FP+BP seconds over the last ``window`` distinct steps.
    ``record_step`` bulk-records a list of samples re-stamped to one step —
    the controller's path for cached simulator samples.
    """

    def __init__(self, window: int = 5, mad_k: float = 3.5,
                 history_steps: int = 64):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self.mad_k = float(mad_k)
        self.history_steps = max(int(history_steps), self.window)
        # (node, step) -> [total seconds, set of micro-batch indices]
        self._acc: Dict[Tuple[int, int], List] = {}
        self._series: Dict[int, _NodeSeries] = {}
        self._links: Dict[Tuple[int, int], _LinkSeries] = {}
        self._kernels: Dict[int, _KernelSeries] = {}
        self.n_samples = 0
        self.n_link_samples = 0
        self.n_kernel_samples = 0

    # ------------------------------------------------------------ recording
    def record(self, sample: StepTiming) -> None:
        key = (int(sample.node), int(sample.step))
        slot = self._acc.get(key)
        if slot is None:
            slot = self._acc[key] = [0.0, set()]
        slot[0] += float(sample.seconds)
        slot[1].add((int(sample.micro_batch)))
        self.n_samples += 1
        self._fold(key, slot)

    def record_step(self, samples: Iterable[StepTiming], step: int) -> None:
        for s in samples:
            self.record(dataclasses.replace(s, step=step))

    def record_link(self, sample: LinkTiming) -> None:
        """Fold one per-transfer link observation into the (src, dst) link's
        per-step (bytes, seconds) totals."""
        key = (int(sample.src), int(sample.dst))
        step = int(sample.step)
        series = self._links.setdefault(key, _LinkSeries())
        if series.steps and series.steps[-1] == step:
            series.nbytes[-1] += float(sample.nbytes)
            series.seconds[-1] += float(sample.seconds)
            series.counts[-1] += 1
        else:
            series.steps.append(step)
            series.nbytes.append(float(sample.nbytes))
            series.seconds.append(float(sample.seconds))
            series.counts.append(1)
            if len(series.steps) > self.history_steps:
                del series.steps[:-self.history_steps]
                del series.nbytes[:-self.history_steps]
                del series.seconds[:-self.history_steps]
                del series.counts[:-self.history_steps]
        self.n_link_samples += 1

    def record_link_step(self, samples: Iterable[LinkTiming],
                         step: int) -> None:
        for s in samples:
            self.record_link(dataclasses.replace(s, step=step))

    def record_kernel(self, sample: KernelTiming) -> None:
        """Fold one per-invocation codec observation into the device's
        per-step (dense bytes, seconds) totals."""
        key = int(sample.node)
        step = int(sample.step)
        series = self._kernels.setdefault(key, _KernelSeries())
        if series.steps and series.steps[-1] == step:
            series.nbytes[-1] += float(sample.nbytes)
            series.seconds[-1] += float(sample.seconds)
            series.counts[-1] += 1
        else:
            series.steps.append(step)
            series.nbytes.append(float(sample.nbytes))
            series.seconds.append(float(sample.seconds))
            series.counts.append(1)
            if len(series.steps) > self.history_steps:
                del series.steps[:-self.history_steps]
                del series.nbytes[:-self.history_steps]
                del series.seconds[:-self.history_steps]
                del series.counts[:-self.history_steps]
        self.n_kernel_samples += 1

    def record_kernel_step(self, samples: Iterable[KernelTiming],
                           step: int) -> None:
        for s in samples:
            self.record_kernel(dataclasses.replace(s, step=step))

    def _fold(self, key: Tuple[int, int], slot: List) -> None:
        """Fold the (node, step) accumulator into the node's series: total
        seconds normalized per micro-batch (the estimator's prediction unit).
        Idempotent per step — later samples for the same step update the
        entry in place."""
        node, step = key
        per_mb = slot[0] / max(1, len(slot[1]))
        series = self._series.setdefault(node, _NodeSeries())
        if series.steps and series.steps[-1] == step:
            series.seconds[-1] = per_mb
        else:
            series.steps.append(step)
            series.seconds.append(per_mb)
            if len(series.steps) > self.history_steps:
                del series.steps[:-self.history_steps]
                del series.seconds[:-self.history_steps]
        # accumulators for steps that scrolled out of history are dropped
        if len(self._acc) > 4 * self.history_steps * max(1, len(self._series)):
            horizon = step - self.history_steps
            self._acc = {k: v for k, v in self._acc.items()
                         if k[1] >= horizon}

    # ----------------------------------------------------------- aggregates
    def nodes(self) -> List[int]:
        return sorted(self._series)

    def node_step_times(self) -> Dict[int, float]:
        """Per-node robust step seconds over the aggregation window — the
        mapping ``StragglerDetector.observe`` consumes."""
        out: Dict[int, float] = {}
        for node, series in self._series.items():
            if not series.seconds:
                continue
            out[node] = _robust_window_stat(series.seconds[-self.window:],
                                            self.mad_k)
        return out

    def link_samples(self, min_steps: int = 3
                     ) -> Dict[Tuple[int, int], List[Tuple[float, float]]]:
        """MAD-filtered ``(nbytes, seconds)`` transfer samples per directed
        link over the aggregation window — the calibration input of
        :func:`repro_torch.core.costmodel.fit_link_corrections`.

        Outlier rejection mirrors :func:`_robust_window_stat`, applied to the
        per-byte pace (seconds per byte) so windows mixing payload sizes are
        judged on the link's rate, not on payload-driven duration swings.
        Links with fewer than ``min_steps`` window entries are withheld: a
        correction fitted from one or two steps is exactly the noisy single
        window hysteresis exists to reject.
        """
        out: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
        for key, series in self._links.items():
            nb = series.nbytes[-self.window:]
            sec = series.seconds[-self.window:]
            cnt = series.counts[-self.window:]
            if len(nb) < max(1, int(min_steps)):
                continue
            pairs = [(b / k, s / k) for b, s, k in zip(nb, sec, cnt)]
            if len(pairs) >= 3:
                pace = np.array([s / max(b, 1.0) for b, s in pairs])
                med = float(np.median(pace))
                mad = float(np.median(np.abs(pace - med)))
                keep = np.abs(pace - med) <= self.mad_k * mad
                if np.any(keep):
                    pairs = [p for p, k in zip(pairs, keep) if k]
            out[key] = pairs
        return out

    def kernel_samples(self, min_steps: int = 3
                       ) -> Dict[int, List[Tuple[float, float]]]:
        """MAD-filtered ``(dense_bytes, seconds)`` codec samples per device
        over the aggregation window — the calibration input of
        :func:`repro_torch.core.costmodel.fit_kernel_costs`.

        Mirrors :meth:`link_samples` exactly: outliers are rejected on the
        per-byte pace, and devices with fewer than ``min_steps`` window
        entries are withheld so a one-step spike never becomes a fitted cost.
        """
        out: Dict[int, List[Tuple[float, float]]] = {}
        for key, series in self._kernels.items():
            nb = series.nbytes[-self.window:]
            sec = series.seconds[-self.window:]
            cnt = series.counts[-self.window:]
            if len(nb) < max(1, int(min_steps)):
                continue
            pairs = [(b / k, s / k) for b, s, k in zip(nb, sec, cnt)]
            if len(pairs) >= 3:
                pace = np.array([s / max(b, 1.0) for b, s in pairs])
                med = float(np.median(pace))
                mad = float(np.median(np.abs(pace - med)))
                keep = np.abs(pace - med) <= self.mad_k * mad
                if np.any(keep):
                    pairs = [p for p, k in zip(pairs, keep) if k]
            out[key] = pairs
        return out

    def latest_step(self) -> Optional[int]:
        steps = [s.steps[-1] for s in self._series.values() if s.steps]
        return max(steps) if steps else None

    def clear(self) -> None:
        """Drop all history — called at every re-plan: a new schedule changes
        every stage's expected time, so old samples must not carry over.
        Link samples are dropped too (the new schedule routes different
        payloads over different wires); installed corrections live on the
        controller and survive."""
        self._acc.clear()
        self._series.clear()
        self._links.clear()
        self._kernels.clear()
        self.n_samples = 0
        self.n_link_samples = 0
        self.n_kernel_samples = 0
