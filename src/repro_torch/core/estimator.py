"""Workload / hardware estimation (FusionLLM §3.5).

The decentralized computing system is a bidirectional graph of CompNodes with
heterogeneous GPU memory ``D^p``, compute speed ``S(p)`` and pairwise link
parameters.  Three models from the paper:

* actual compute speed  S(p) = λ_p · S*(p)   (λ fitted by warm-up profiling)
* link cost             T_comm^{ij}(M) = α^{ij} + β^{ij} · M
* per-op time           T(f,p) = R(Pa(f)) + C(f,p) + W(f,p),   Eq. (1)
  with C(f,p) = FLOPs(f)/S(p); R is a link transfer when f and Pa(f) live on
  different CompNodes and ~0 otherwise; W (local write) is ignored as in the
  paper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .opgraph import OpGraph, OpProfile


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One CompNode's hardware sheet (paper Table 1 rows + λ_p)."""

    name: str
    peak_flops: float          # S*(p), FLOP/s
    mem_bytes: float           # D^p_gpu
    lam: float = 1.0           # λ_p scaling-down factor (warm-up profiled)

    @property
    def speed(self) -> float:  # S(p)
        return self.lam * self.peak_flops


# Representative consumer/datacenter sheets (paper Table 1, fp16 tensor FLOPS).
DEVICE_SHEETS: Dict[str, Tuple[float, float]] = {
    "H100":     (756e12, 80e9),
    "A100":     (311.84e12, 80e9),
    "RTX4090":  (165.16e12, 24e9),
    "RTX4080":  (97.5e12, 16e9),
    "RTX3080":  (59.5e12, 10e9),
    "RTX2080":  (40.0e12, 8e9),
    "TPUv5e":   (197e12, 16e9),
}


def make_device(name: str, sheet: str, lam: float = 1.0) -> DeviceSpec:
    peak, mem = DEVICE_SHEETS[sheet]
    return DeviceSpec(name=name, peak_flops=peak, mem_bytes=mem, lam=lam)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """α–β model for one directed link."""

    alpha: float               # latency, seconds
    beta: float                # seconds per byte (1/bandwidth)

    def time(self, nbytes: float) -> float:
        return self.alpha + self.beta * float(nbytes)

    @property
    def bandwidth(self) -> float:
        return 1.0 / self.beta if self.beta > 0 else float("inf")


LOCAL_LINK = LinkSpec(alpha=0.0, beta=0.0)


class ClusterSpec:
    """CompNode group P = <{p_i}, {p_i,p_j}> with pairwise α–β links."""

    def __init__(self, devices: Sequence[DeviceSpec],
                 links: Mapping[Tuple[int, int], LinkSpec]):
        self.devices = list(devices)
        self._links = dict(links)
        n = len(self.devices)
        for (i, j) in self._links:
            if not (0 <= i < n and 0 <= j < n):
                raise ValueError(f"link ({i},{j}) out of range for {n} devices")

    def __len__(self) -> int:
        return len(self.devices)

    def link(self, i: int, j: int) -> LinkSpec:
        if i == j:
            return LOCAL_LINK
        if (i, j) in self._links:
            return self._links[(i, j)]
        if (j, i) in self._links:
            return self._links[(j, i)]
        raise KeyError(f"no link between CompNodes {i} and {j}")

    def comm_time(self, i: int, j: int, nbytes: float) -> float:
        return self.link(i, j).time(nbytes)

    def bandwidth_matrix(self) -> np.ndarray:
        n = len(self.devices)
        bw = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                if i != j:
                    bw[i, j] = self.link(i, j).bandwidth
        return bw

    def compute_time(self, flops: float, p: int) -> float:
        """C(f,p) = FLOPs(f) / S(p)."""
        return flops / self.devices[p].speed

    def links(self) -> Dict[Tuple[int, int], LinkSpec]:
        """Copy of the directed link table (topology transforms use this)."""
        return dict(self._links)

    def with_devices(self, devices: Sequence[DeviceSpec]) -> "ClusterSpec":
        """Same topology, replaced device sheets (elastic runtime: degraded
        λ_p for stragglers, restored λ_p on recovery)."""
        if len(devices) != len(self.devices):
            raise ValueError("device count must match the topology")
        return ClusterSpec(devices, self._links)


def fit_lambda(measured_flops_per_s: float, peak_flops: float) -> float:
    """Regression-based scaling-down factor λ_p = S(p)/S*(p) (paper cites
    Paleo).  With a single warm-up measurement this is a ratio; with several,
    the least-squares slope of achieved-vs-peak."""
    return float(measured_flops_per_s) / float(peak_flops)


def fit_lambda_regression(flops: Sequence[float], seconds: Sequence[float],
                          peak_flops: float) -> float:
    """λ from multiple warm-up profiles: least-squares slope through origin of
    time = FLOPs / (λ·S*)."""
    f = np.asarray(flops, dtype=np.float64)
    t = np.asarray(seconds, dtype=np.float64)
    # time = f / (lam*peak)  =>  lam = sum(f^2) / (peak * sum(f*t))  (LS)
    denom = peak_flops * float(np.dot(f, t))
    if denom <= 0:
        raise ValueError("degenerate warm-up profile")
    return float(np.dot(f, f)) / denom


def fit_alpha_beta(sizes: Sequence[float], seconds: Sequence[float]) -> LinkSpec:
    """Least-squares α–β fit from ping-pong style measurements."""
    M = np.stack([np.ones(len(sizes)), np.asarray(sizes, dtype=np.float64)], axis=1)
    sol, *_ = np.linalg.lstsq(M, np.asarray(seconds, dtype=np.float64), rcond=None)
    alpha, beta = float(max(sol[0], 0.0)), float(max(sol[1], 0.0))
    return LinkSpec(alpha=alpha, beta=beta)


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Estimated cost of one op on its assigned CompNode (Eq. 1 terms)."""

    name: str
    comp_time: float       # C(f,p)
    recv_time: float       # R(Pa(f)) — only cross-CompNode parents
    recv_bytes: int
    send_bytes: int

    @property
    def total(self) -> float:
        return self.comp_time + self.recv_time


def estimate_op_costs(graph: OpGraph,
                      profiles: Mapping[str, OpProfile],
                      cluster: ClusterSpec,
                      placement: Mapping[str, int],
                      cost_model=None,
                      backward: bool = False) -> Dict[str, OpCost]:
    """Per-op Eq.(1) costs under a placement {op -> CompNode index}.

    All transported-byte accounting flows through the unified
    :class:`repro_torch.core.costmodel.EdgeCostModel`: a cross-node edge's payload
    is the model's exact integer wire encoding under its compression plan
    (dense when the model carries no plan).  ``cost_model`` defaults to a
    dense model over ``(graph, profiles, cluster)``; pass
    ``EdgeCostModel(..., plan=plan)`` to estimate under compression — this
    replaces the removed ad-hoc ``compress_ratio`` mapping, whose smooth
    ``3/r`` approximation disagreed with the executor's exact wire bytes.
    """
    if cost_model is None:
        from .costmodel import EdgeCostModel   # late: costmodel imports us
        cost_model = EdgeCostModel(graph, profiles, cluster)
    costs: Dict[str, OpCost] = {}
    for n, node in graph.nodes.items():
        p = placement[n]
        prof = profiles[n]
        flops = prof.bwd_flops if backward else prof.fwd_flops
        comp = cluster.compute_time(flops, p)
        recv = 0.0
        recv_bytes = 0
        for a in node.args:
            q = placement[a]
            if q == p:
                continue
            nbytes = cost_model.edge_wire_bytes(a, n)
            recv += cost_model.link_seconds(q, p, nbytes)
            recv_bytes += int(nbytes)
        send_bytes = 0
        for u in graph.users[n]:
            if placement[u] != p:
                send_bytes += int(cost_model.edge_wire_bytes(n, u))
        costs[n] = OpCost(name=n, comp_time=comp, recv_time=recv,
                          recv_bytes=recv_bytes, send_bytes=send_bytes)
    return costs


def predict_step_time_components(graph: OpGraph,
                                 profiles: Mapping[str, OpProfile],
                                 cluster: ClusterSpec,
                                 placement: Mapping[str, int],
                                 cost_model=None,
                                 ) -> Dict[int, Tuple[float, float]]:
    """Per-CompNode (compute, recv) predicted FP+BP seconds, one micro-batch.

    Both directions of every cross-node edge are charged to the CompNode
    owning the *consumer* op — the attribution the executor's telemetry
    samples reproduce, so predictions and observations decompose identically.
    ``cost_model`` (see :func:`estimate_op_costs`) carries the compression
    plan and any telemetry-calibrated link corrections.
    """
    fwd = estimate_op_costs(graph, profiles, cluster, placement,
                            cost_model, backward=False)
    bwd = estimate_op_costs(graph, profiles, cluster, placement,
                            cost_model, backward=True)
    out: Dict[int, Tuple[float, float]] = {}
    for n in graph.nodes:
        p = placement[n]
        comp, recv = out.get(p, (0.0, 0.0))
        out[p] = (comp + fwd[n].comp_time + bwd[n].comp_time,
                  recv + fwd[n].recv_time + bwd[n].recv_time)
    return out


def predict_step_times(graph: OpGraph,
                       profiles: Mapping[str, OpProfile],
                       cluster: ClusterSpec,
                       placement: Mapping[str, int],
                       cost_model=None,
                       ) -> Dict[int, float]:
    """Per-CompNode predicted FP+BP seconds for one micro-batch.

    Sums Eq. (1) over each CompNode's assigned ops, forward and backward.
    This is the *reference prediction* the elastic straggler detector
    compares against — never the observation source: observations come from
    executor telemetry (:class:`repro_torch.elastic.telemetry.TelemetryLog`), so a
    node is judged by its measured pace, not by re-running the model that
    scheduled it.

    Under closed-loop calibration the controller re-evaluates this with a
    corrections-bearing ``cost_model`` after every accepted link fit and
    *re-prices* the detector in place
    (:meth:`repro_torch.elastic.detector.StragglerDetector.reprice`) — the
    prediction tracks the links as measured, so a slow-but-known wire stops
    looking like a slow node.
    """
    out: Dict[int, float] = {}
    for p, (comp, recv) in predict_step_time_components(
            graph, profiles, cluster, placement, cost_model).items():
        out[p] = comp + recv
    return out
