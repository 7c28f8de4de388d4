"""OP-Fence scheduler (FusionLLM §4).

Observation 2 (network locality): bandwidth clusters exist.  OP-Fence
1. detects high-bandwidth clusters of CompNodes with the Louvain algorithm
   over the bandwidth graph,
2. orders clusters into a pipeline path that keeps consecutive stages on
   well-connected clusters,
3. splits the op chain across clusters proportionally to aggregate compute,
4. within each cluster, solves the DP min-bottleneck split (partition.py),
so every cluster holds a *connected* sub-graph and only cluster-boundary
(slow) edges carry inter-cluster traffic — the "fence".

Baselines (paper §7.2): ``schedule_equal_number`` / ``schedule_equal_compute``
ignore network structure and allocate segments to CompNodes in index order.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .costmodel import EdgeCostModel
from .estimator import ClusterSpec
from .opgraph import OpGraph, OpProfile, build_subdags, SubDag
from .partition import (partition_equal_compute, partition_equal_number,
                        partition_min_bottleneck, attach_sources,
                        _segments_to_assignment)
from .opgraph import chain as op_chain


# --------------------------------------------------------------- Louvain ---
def louvain_communities(weights: np.ndarray, seed: int = 0,
                        max_passes: int = 16) -> List[List[int]]:
    """Weighted-graph Louvain (Blondel et al. 2008), self-contained.

    ``weights`` is a symmetric non-negative matrix (bandwidth as edge weight;
    0 = no edge).  Returns communities as lists of original node indices.
    """
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError("weights must be square")
    w = (w + w.T) / 2.0
    np.fill_diagonal(w, 0.0)  # no self-loops in the input graph
    n0 = w.shape[0]
    members: List[List[int]] = [[i] for i in range(n0)]
    rng = np.random.default_rng(seed)

    while True:
        n = w.shape[0]
        m2 = w.sum()  # = 2m (self-loops carry intra-community weight upward)
        if m2 <= 0:
            break
        k = w.sum(axis=1)              # weighted degree (self-loop included)
        comm = np.arange(n)            # community of each super-node
        # Σ_tot per community; Σ_in not needed for the move gain formula below.
        tot = k.copy()

        improved_any = False
        for _pass in range(max_passes):
            improved = False
            order = rng.permutation(n)
            for i in order:
                ci = comm[i]
                # links from i to each community (self-loop excluded — it is
                # community-invariant and cancels in the gain)
                nb = {}
                for j in np.nonzero(w[i])[0]:
                    if j != i:
                        nb[comm[j]] = nb.get(comm[j], 0.0) + w[i, j]
                # remove i from its community
                tot[ci] -= k[i]
                best_c, best_gain = ci, 0.0
                base = nb.get(ci, 0.0) - tot[ci] * k[i] / m2
                for c, w_ic in nb.items():
                    gain = (w_ic - tot[c] * k[i] / m2) - base
                    if gain > best_gain + 1e-15:
                        best_gain, best_c = gain, c
                tot[best_c] += k[i]
                if best_c != ci:
                    comm[i] = best_c
                    improved = improved_any = True
            if not improved:
                break
        if not improved_any:
            break
        # aggregate
        labels = {c: idx for idx, c in enumerate(sorted(set(comm.tolist())))}
        nn = len(labels)
        if nn == n:
            break
        new_members: List[List[int]] = [[] for _ in range(nn)]
        for i in range(n):
            new_members[labels[comm[i]]].extend(members[i])
        neww = np.zeros((nn, nn))
        for i in range(n):
            for j in range(n):
                neww[labels[comm[i]], labels[comm[j]]] += w[i, j]
        # keep the diagonal: intra-community weight must survive aggregation
        # or upper levels see only inter-community edges and merge everything.
        w, members = neww, new_members
    return [sorted(m) for m in members]


# ------------------------------------------------------------- schedules ---
@dataclasses.dataclass
class Schedule:
    """Result of scheduling: ops per CompNode + derived sub-DAG edge sets.

    ``assignment[p]`` is the op list on CompNode p (may be empty); ``stages``
    is the pipeline order of the non-empty CompNodes.
    """

    assignment: List[List[str]]
    stages: List[int]
    clusters: Optional[List[List[int]]] = None
    predicted_pace: Optional[float] = None

    @property
    def placement(self) -> Dict[str, int]:
        return {n: p for p, seg in enumerate(self.assignment) for n in seg}

    def subdags(self, graph: OpGraph) -> List[SubDag]:
        return build_subdags(graph, self.assignment)

    def pipeline_subdags(self, graph: OpGraph) -> List[SubDag]:
        """Non-empty sub-DAGs in *pipeline stage order* (what the RAD
        executor needs — required activations always come from an earlier
        stage).  ``subdags()[i].index`` is the CompNode; here index is the
        stage position."""
        segments = [self.assignment[d] for d in self.stages
                    if self.assignment[d]]
        covered = sum(len(s) for s in segments)
        total = sum(len(s) for s in self.assignment)
        if covered != total:
            raise ValueError("stages do not cover all assigned ops")
        return build_subdags(graph, segments)

    def stage_devices(self) -> List[int]:
        return [d for d in self.stages if self.assignment[d]]


def _to_full_assignment(segments: List[List[str]], stage_devices: Sequence[int],
                        n_devices: int) -> Tuple[List[List[str]], List[int]]:
    assignment: List[List[str]] = [[] for _ in range(n_devices)]
    stages: List[int] = []
    for seg, dev in zip(segments, stage_devices):
        assignment[dev] = seg
        stages.append(dev)
    return assignment, stages


def _resolve_subset(cluster: ClusterSpec,
                    device_subset: Optional[Sequence[int]]) -> List[int]:
    """Validated CompNode subset, ascending (full cluster when None)."""
    if device_subset is None:
        return list(range(len(cluster)))
    subset = sorted(set(int(d) for d in device_subset))
    if not subset:
        raise ValueError("device_subset must name at least one CompNode")
    if subset[0] < 0 or subset[-1] >= len(cluster):
        raise ValueError("device_subset out of range")
    return subset


def schedule_equal_number(graph: OpGraph, cluster: ClusterSpec,
                          device_subset: Optional[Sequence[int]] = None,
                          ) -> Schedule:
    """Baseline 1.  ``device_subset`` restricts placement to the listed
    CompNodes (index order) — baselines must not silently schedule onto dead
    nodes in churn experiments."""
    devs = _resolve_subset(cluster, device_subset)
    n = max(1, min(len(devs), len(op_chain(graph))))
    segs = partition_equal_number(graph, n)
    a, s = _to_full_assignment(segs, devs[:n], len(cluster))
    return Schedule(assignment=a, stages=s)


def schedule_equal_compute(graph: OpGraph, profiles: Mapping[str, OpProfile],
                           cluster: ClusterSpec,
                           device_subset: Optional[Sequence[int]] = None,
                           ) -> Schedule:
    """Baseline 2; ``device_subset`` as in :func:`schedule_equal_number`."""
    devs = _resolve_subset(cluster, device_subset)
    n = max(1, min(len(devs), len(op_chain(graph))))
    segs = partition_equal_compute(graph, profiles, n)
    a, s = _to_full_assignment(segs, devs[:n], len(cluster))
    return Schedule(assignment=a, stages=s)


def _order_clusters(clusters: List[List[int]], bw: np.ndarray) -> List[int]:
    """Pipeline order over clusters: greedy max-bandwidth path (nearest
    neighbour on mean inter-cluster bandwidth), exhaustive when ≤ 6 clusters."""
    nc = len(clusters)
    if nc == 1:
        return [0]
    inter = np.zeros((nc, nc))
    for a in range(nc):
        for b in range(nc):
            if a != b:
                vals = [bw[i, j] for i in clusters[a] for j in clusters[b]]
                inter[a, b] = float(np.mean(vals)) if vals else 0.0

    def path_cost(path: Sequence[int]) -> float:
        # maximize the weakest consecutive link, then the sum
        links = [inter[path[i], path[i + 1]] for i in range(len(path) - 1)]
        return min(links) * 1e6 + sum(links)

    if nc <= 6:
        return list(max(itertools.permutations(range(nc)), key=path_cost))
    # greedy from the strongest edge
    a, b = np.unravel_index(np.argmax(inter), inter.shape)
    path = [int(a), int(b)]
    rest = set(range(nc)) - set(path)
    while rest:
        head, tail = path[0], path[-1]
        cand = max(rest, key=lambda c: max(inter[c, head], inter[tail, c]))
        if inter[cand, head] > inter[tail, cand]:
            path.insert(0, cand)
        else:
            path.append(cand)
        rest.remove(cand)
    return path


def schedule_opfence(graph: OpGraph, profiles: Mapping[str, OpProfile],
                     cluster: ClusterSpec, seed: int = 0,
                     cost_model: Optional[EdgeCostModel] = None,
                     device_subset: Optional[Sequence[int]] = None,
                     verify: bool = True,
                     ) -> Schedule:
    """The OP-Fence scheduler.

    ``cost_model`` is the unified byte/seconds source the DP split reads; a
    plan-bearing :class:`repro_torch.core.costmodel.EdgeCostModel` re-schedules
    under that compression plan (AdaTopK shrinks the slowest edges, which can
    change the optimal split).  Defaults to dense transport.

    ``device_subset`` restricts placement to the listed CompNodes (the elastic
    runtime re-plans on the survivors after churn); the returned Schedule
    still spans the full device index space, with excluded CompNodes empty.

    ``verify=True`` (default) runs the emitted schedule through the
    :mod:`repro_torch.check` static verifier (coverage, contiguity, subset
    membership) and raises :class:`repro_torch.check.ScheduleCheckError` on any
    violation — a planner bug must surface here, not as a silently wrong
    pace downstream.  ``verify=False`` opts out (hot inner loops).
    """
    bw = cluster.bandwidth_matrix()
    subset = _resolve_subset(cluster, device_subset)
    if cost_model is None:
        cost_model = EdgeCostModel(graph, profiles, cluster)
    # Louvain on the surviving sub-graph, communities mapped back to the
    # original CompNode indices so link lookups stay in the full topology.
    sub_bw = bw[np.ix_(subset, subset)]
    clusters = [[subset[i] for i in c]
                for c in louvain_communities(sub_bw, seed=seed)]
    order = _order_clusters(clusters, bw)
    # Device pipeline order: clusters in path order; inside a cluster, fastest
    # devices first (they will absorb the bigger DP segments).
    device_order: List[int] = []
    for c in order:
        device_order.extend(sorted(clusters[c],
                                   key=lambda i: -cluster.devices[i].speed))
    n_ops = len(op_chain(graph))
    device_order = device_order[:max(1, min(len(device_order), n_ops))]
    segs, pace = partition_min_bottleneck(graph, profiles, cluster,
                                          device_order,
                                          cost_model=cost_model)
    a, s = _to_full_assignment(segs, device_order, len(cluster))
    sched = Schedule(assignment=a, stages=s,
                     clusters=[clusters[c] for c in order],
                     predicted_pace=pace)
    if verify:
        from repro_torch.check.schedule import verify_schedule
        verify_schedule(graph, sched, profiles=profiles, cluster=cluster,
                        alive=subset, check_capacity=False)
    return sched


SCHEDULERS = {
    "equal_number":
        lambda g, prof, cl, **kw: schedule_equal_number(g, cl, **kw),
    "equal_compute":
        lambda g, prof, cl, **kw: schedule_equal_compute(g, prof, cl, **kw),
    "opfence": lambda g, prof, cl, **kw: schedule_opfence(g, prof, cl, **kw),
}
