"""Unified edge-cost model — the single source of truth for transported bytes.

Before this layer existed the codebase carried **three inconsistent byte
models** that could not compose:

* ``partition.py`` scaled stage-boundary bytes with an ad-hoc stage-indexed
  ``edge_bytes_scale`` mapping,
* ``estimator.py`` approximated compression with a smooth per-edge
  ``compress_ratio`` (``bytes · 3/r``, no integer rounding, fp32 hard-coded),
* ``compression.py`` / ``executor.py`` used the exact integer
  :func:`repro_torch.core.compression.wire_bytes` encoding.

The planner therefore scheduled on one arithmetic and simulated on another —
and AdaTopK, which *changes* which cut is bottleneck-optimal, could not feed
back into the DP at all.  :class:`EdgeCostModel` composes, per op-pair edge:

* the α–β link model of :class:`repro_torch.core.estimator.ClusterSpec`,
* the exact integer wire encoding (dtype-aware itemsize derived from the
  producer's profile, index overhead, break-even clamp) under an optional
  :class:`repro_torch.core.compression.CompressionPlan`,
* optional telemetry-calibrated per-link corrections (a measured/modeled
  seconds ratio fitted by :func:`fit_link_corrections`),
* optional telemetry-calibrated per-device **kernel costs** — the compute
  seconds the fused compression codec spends per edge
  (:class:`KernelCostModel`, fitted by :func:`fit_kernel_costs` from
  ``KernelTiming`` samples), so planners stop pricing compression at zero.

Every byte-accounting consumer — the min-bottleneck DP, OP-Fence, the Eq. 1
estimator, the discrete-event simulator, AdaTopK planning, and the elastic
re-planner — now reads this one model, so "schedule under compressed costs"
is just ``model.with_plan(plan)``.  The stage-boundary view the DP needs is
*derived* from op-pair costs (the boundary edge between consecutive chain
segments is itself an op pair), never duplicated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np

from .compression import CompressionPlan, wire_bytes
from .estimator import ClusterSpec
from .opgraph import OpGraph, OpProfile


@dataclasses.dataclass(frozen=True)
class KernelCostModel:
    """Per-device compression-codec cost: ``seconds(d) = alpha + d/B`` for
    ``d`` dense payload bytes through the fused encode(+EF) kernel.

    ``alpha`` is the fixed launch/dispatch overhead; ``bytes_per_second``
    the codec's streaming throughput (``inf`` = free, the legacy
    assumption).  Fitted per device by :func:`fit_kernel_costs` from
    ``KernelTiming`` telemetry."""

    alpha: float = 0.0
    bytes_per_second: float = float("inf")

    def seconds(self, dense_bytes: float) -> float:
        t = float(self.alpha)
        if np.isfinite(self.bytes_per_second) and self.bytes_per_second > 0:
            t += float(dense_bytes) / float(self.bytes_per_second)
        return t


@dataclasses.dataclass(frozen=True)
class EdgeCost:
    """Fully resolved cost of one cross-CompNode edge."""

    producer: str
    consumer: str
    src: int
    dst: int
    dense_bytes: float         # uncompressed payload at the producer's dtype
    wire_bytes: float          # exact on-the-wire bytes under the plan
    seconds: float             # α + β·wire_bytes, link-corrected


class EdgeCostModel:
    """Per-edge transported bytes and seconds, keyed by (producer, consumer).

    Immutable by convention: derive variants with :meth:`with_plan` /
    :meth:`with_cluster` / :meth:`with_link_corrections` /
    :meth:`with_kernel_costs` instead of mutating.  ``plan=None`` means dense
    transport; ``link_corrections`` maps a directed CompNode pair ``(i, j)``
    to a multiplicative correction on the modeled link seconds (1.0 = trust
    the α–β fit); ``kernel_costs`` maps a device id to its
    :class:`KernelCostModel` (absent = codec priced free, the legacy
    behaviour, so unpinned baselines are unchanged).
    """

    def __init__(self, graph: OpGraph, profiles: Mapping[str, OpProfile],
                 cluster: ClusterSpec,
                 plan: Optional[CompressionPlan] = None,
                 link_corrections: Optional[Mapping[Tuple[int, int], float]] = None,
                 kernel_costs: Optional[Mapping[int, KernelCostModel]] = None):
        self.graph = graph
        self.profiles = profiles
        self.cluster = cluster
        self.plan = plan
        self.link_corrections = dict(link_corrections or {})
        self.kernel_costs = dict(kernel_costs or {})

    # ------------------------------------------------------------ variants --
    def with_plan(self, plan: Optional[CompressionPlan]) -> "EdgeCostModel":
        return EdgeCostModel(self.graph, self.profiles, self.cluster, plan,
                             self.link_corrections, self.kernel_costs)

    def with_cluster(self, cluster: ClusterSpec) -> "EdgeCostModel":
        return EdgeCostModel(self.graph, self.profiles, cluster, self.plan,
                             self.link_corrections, self.kernel_costs)

    def with_link_corrections(self, corrections: Mapping[Tuple[int, int], float]
                              ) -> "EdgeCostModel":
        return EdgeCostModel(self.graph, self.profiles, self.cluster,
                             self.plan, corrections, self.kernel_costs)

    def with_kernel_costs(self, kernel_costs: Mapping[int, KernelCostModel]
                          ) -> "EdgeCostModel":
        return EdgeCostModel(self.graph, self.profiles, self.cluster,
                             self.plan, self.link_corrections, kernel_costs)

    # -------------------------------------------------------------- per-op --
    def numel(self, op: str) -> int:
        return int(np.prod(self.profiles[op].out_shape)) \
            if self.profiles[op].out_shape else 1

    def itemsize(self, op: str) -> int:
        """Activation itemsize derived from the producer's profile (the
        profile's ``out_bytes`` already encodes the dtype the broker annotated
        the graph with — bf16 boundaries are 2 bytes/elem, not a hard-coded
        4)."""
        n = self.numel(op)
        if n <= 0:
            return 4
        return max(1, int(round(self.profiles[op].out_bytes / n)))

    def dense_bytes(self, op: str) -> float:
        """Uncompressed payload of one boundary tensor."""
        return float(self.profiles[op].out_bytes)

    # ------------------------------------------------------------ per-edge --
    def ratio(self, producer: str, consumer: str) -> float:
        if self.plan is None:
            return 1.0
        return self.plan.ratio(producer, consumer)

    @property
    def encoding(self) -> str:
        return self.plan.encoding if self.plan is not None else "none"

    def edge_wire_bytes(self, producer: str, consumer: str) -> float:
        """Exact integer-encoding bytes on the wire for one edge, under the
        plan's ratio (dense when unplanned) at the producer's dtype."""
        r = self.ratio(producer, consumer)
        if r <= 1.0 or self.encoding == "none":
            return self.dense_bytes(producer)   # exact, even for 0-byte ops
        return wire_bytes(self.numel(producer), r, self.encoding,
                          itemsize=self.itemsize(producer))

    def link_seconds(self, src: int, dst: int, nbytes: float) -> float:
        """α–β seconds for ``nbytes`` on the (src, dst) link, scaled by the
        telemetry-calibrated correction when one was fitted."""
        t = self.cluster.comm_time(src, dst, nbytes)
        return t * self.link_corrections.get((src, dst), 1.0)

    def edge_seconds(self, producer: str, consumer: str,
                     src: int, dst: int) -> float:
        """Transport seconds of one edge's payload over the (src, dst) link."""
        if src == dst:
            return 0.0
        return self.link_seconds(src, dst,
                                 self.edge_wire_bytes(producer, consumer))

    def compress_seconds(self, producer: str, consumer: str,
                         device: int) -> float:
        """Compute seconds the fused compression codec spends on one edge's
        payload, on ``device``'s codec stream (the encoder side — the
        transfer's source).  Zero when the edge is unplanned/dense or the
        device has no calibrated kernel cost (legacy: compression is free).
        The term covers the whole codec (encode + EF update; decode rides
        the same calibrated throughput)."""
        r = self.ratio(producer, consumer)
        if r <= 1.0 or self.encoding == "none":
            return 0.0
        kc = self.kernel_costs.get(device)
        if kc is None:
            return 0.0
        return kc.seconds(self.dense_bytes(producer))

    def edge_cost(self, producer: str, consumer: str,
                  src: int, dst: int) -> EdgeCost:
        wb = self.edge_wire_bytes(producer, consumer)
        return EdgeCost(producer=producer, consumer=consumer, src=src, dst=dst,
                        dense_bytes=self.dense_bytes(producer), wire_bytes=wb,
                        seconds=0.0 if src == dst
                        else self.link_seconds(src, dst, wb))

    # --------------------------------------------------------------- views --
    def cross_edges(self, placement: Mapping[str, int]
                    ) -> Iterator[Tuple[str, str]]:
        """(producer, consumer) pairs crossing CompNodes under a placement."""
        for n, node in self.graph.nodes.items():
            for a in node.args:
                if placement[a] != placement[n]:
                    yield (a, n)

    def stage_pace(self, schedule) -> float:
        """Eq. 3 steady-state pace ``max_k max(C_k, R_k, E_k)`` of a schedule
        under this model — the *derived* stage-boundary view.

        ``C_k`` uses forward FLOPs (the same objective the min-bottleneck DP
        optimizes) and ``R_k`` charges every cross-stage edge to the CompNode
        owning the consumer op, the shared attribution of estimator,
        simulator, and telemetry.  ``E_k`` is the codec stream: per-device
        fused-encode seconds summed over the edges *produced* there — the
        codec double-buffers against the next micro-batch's compute, so in
        steady state it bounds pace exactly like ``C`` and ``R`` do (zero
        unless kernel costs are calibrated).
        """
        placement = schedule.placement
        comp: Dict[int, float] = {}
        recv: Dict[int, float] = {}
        enc: Dict[int, float] = {}
        for d in schedule.stage_devices():
            comp[d] = sum(self.profiles[n].fwd_flops
                          for n in schedule.assignment[d]) \
                / self.cluster.devices[d].speed
            recv[d] = 0.0
            enc[d] = 0.0
        for (a, n) in self.cross_edges(placement):
            recv[placement[n]] = recv.get(placement[n], 0.0) + \
                self.edge_seconds(a, n, placement[a], placement[n])
            enc[placement[a]] = enc.get(placement[a], 0.0) + \
                self.compress_seconds(a, n, placement[a])
        return max((max(comp[d], recv[d], enc.get(d, 0.0)) for d in comp),
                   default=0.0)


def fit_link_corrections(measured: Mapping[Tuple[int, int],
                                           Sequence[Tuple[float, float]]],
                         cluster,
                         clamp: Tuple[float, float] = (0.25, 4.0)
                         ) -> Dict[Tuple[int, int], float]:
    """Telemetry-calibrated link corrections.

    ``measured[(i, j)]`` is a sequence of ``(nbytes, observed_seconds)``
    transfer samples on the directed (i, j) link.  The correction is the
    least-squares scale of observed vs α–β-modeled seconds (slope through the
    origin), clamped to ``clamp`` so one pathological sample cannot swing the
    planner by orders of magnitude.  Feed the result to
    :meth:`EdgeCostModel.with_link_corrections`.

    Corrections are **absolute** multipliers on the *uncorrected* α–β spec:
    re-fits replace what is installed, they never compose with it.  The clamp
    makes composing actively dangerous — each re-fit of a badly degraded link
    can contribute up to ``clamp[1]``, so corrections stacked across windows
    drift geometrically (``4, 16, 64, …``) under perfectly stationary
    telemetry instead of converging on the true ratio.  To make that mistake
    unrepresentable, ``cluster`` may be either a bare :class:`ClusterSpec` or
    an :class:`EdgeCostModel`; a model is reduced to its **base** cluster and
    any corrections it already carries are ignored, so the fit always
    measures observed seconds against the pristine spec.
    """
    if isinstance(cluster, EdgeCostModel):
        cluster = cluster.cluster   # the uncorrected α–β base, by definition
    lo, hi = clamp
    out: Dict[Tuple[int, int], float] = {}
    for (i, j), samples in measured.items():
        pred = np.array([cluster.comm_time(i, j, nb) for nb, _ in samples],
                        dtype=np.float64)
        obs = np.array([s for _, s in samples], dtype=np.float64)
        denom = float(np.dot(pred, pred))
        if denom <= 0.0:
            continue
        out[(i, j)] = float(np.clip(np.dot(pred, obs) / denom, lo, hi))
    return out


def fit_kernel_costs(measured: Mapping[int, Sequence[Tuple[float, float]]]
                     ) -> Dict[int, KernelCostModel]:
    """Telemetry-calibrated per-device codec costs.

    ``measured[device]`` is a sequence of ``(dense_bytes, seconds)``
    ``KernelTiming`` samples from that device's fused compression codec.
    Fit is the least-squares seconds-per-byte slope through the origin —
    the same estimator shape as :func:`fit_link_corrections`, so outliers
    already rejected by the telemetry MAD window cannot tilt it.  Devices
    with degenerate samples (no bytes, non-positive slope) are skipped:
    absence means "priced free", never "priced garbage"."""
    out: Dict[int, KernelCostModel] = {}
    for device, samples in measured.items():
        b = np.array([nb for nb, _ in samples], dtype=np.float64)
        s = np.array([sec for _, sec in samples], dtype=np.float64)
        denom = float(np.dot(b, b))
        if denom <= 0.0:
            continue
        slope = float(np.dot(b, s) / denom)   # seconds per dense byte
        if slope <= 0.0 or not np.isfinite(slope):
            continue
        out[int(device)] = KernelCostModel(alpha=0.0,
                                           bytes_per_second=1.0 / slope)
    return out
