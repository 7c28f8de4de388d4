"""OP-DAG partitioning (FusionLLM §4 + baselines from §7.2).

Three chain partitioners (Observation 1: DNN DAGs are near-chains, so we
linearize topologically and split into contiguous segments — contiguity also
guarantees each sub-DAG is a connected sub-graph, which OP-Fence requires):

* ``partition_equal_number``  — baseline 1: same #ops per CompNode.
* ``partition_equal_compute`` — baseline 2: balance Σ FLOPs per CompNode.
* ``partition_min_bottleneck``— DP-optimal contiguous split minimizing the
  pipelined bottleneck max_p max(C_p, R_p) of Eq. 3 (used inside OP-Fence).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .estimator import ClusterSpec
from .opgraph import OpGraph, OpProfile, chain


def _segments_to_assignment(order: Sequence[str], cuts: Sequence[int]) -> List[List[str]]:
    """cuts = segment end indices (exclusive), ascending, last == len(order)."""
    out: List[List[str]] = []
    start = 0
    for c in cuts:
        out.append(list(order[start:c]))
        start = c
    return out


def attach_sources(graph: OpGraph, assignment: List[List[str]]) -> List[List[str]]:
    """Place each placeholder/variable with its first consumer's segment (the
    paper puts Input with CompNode 1, Label with the loss's CompNode)."""
    owner: Dict[str, int] = {}
    for k, seg in enumerate(assignment):
        for n in seg:
            owner[n] = k
    users = graph.users
    for n, node in graph.nodes.items():
        if n in owner:
            continue
        cons = [owner[u] for u in users[n] if u in owner]
        k = min(cons) if cons else 0
        assignment[k].insert(0, n)
        owner[n] = k
    return assignment


def partition_equal_number(graph: OpGraph, n_parts: int) -> List[List[str]]:
    """Baseline: equal number of (compute) ops per part."""
    order = chain(graph)
    n = len(order)
    if n_parts > n:
        raise ValueError(f"cannot split {n} ops into {n_parts} parts")
    cuts = [round((i + 1) * n / n_parts) for i in range(n_parts)]
    cuts[-1] = n
    # De-duplicate rounding collisions while keeping each segment non-empty.
    for i in range(1, n_parts):
        if cuts[i] <= cuts[i - 1]:
            cuts[i] = cuts[i - 1] + 1
    if cuts[-1] != n:
        raise ValueError("rounding produced an invalid split")
    return attach_sources(graph, _segments_to_assignment(order, cuts))


def partition_equal_compute(graph: OpGraph, profiles: Mapping[str, OpProfile],
                            n_parts: int,
                            weights: Optional[Mapping[str, float]] = None) -> List[List[str]]:
    """Baseline: balance cumulative FLOPs — greedy prefix walk toward the
    ideal total/ n_parts per segment."""
    order = chain(graph)
    w = np.array([(weights or {}).get(n, profiles[n].fwd_flops) for n in order],
                 dtype=np.float64)
    w = np.maximum(w, 1e-9)
    target = w.sum() / n_parts
    cuts: List[int] = []
    acc = 0.0
    for i, wi in enumerate(w):
        acc += wi
        remaining_ops = len(order) - (i + 1)
        remaining_parts = n_parts - len(cuts) - 1
        if len(cuts) < n_parts - 1 and (acc >= target or remaining_ops == remaining_parts):
            cuts.append(i + 1)
            acc = 0.0
    cuts.append(len(order))
    return attach_sources(graph, _segments_to_assignment(order, cuts))


def min_bottleneck_chain(ops: Sequence[str],
                         profiles: Mapping[str, OpProfile],
                         cluster: ClusterSpec,
                         device_order: Sequence[int],
                         cost_model,
                         inbound: Optional[Tuple[str, int]] = None,
                         ) -> Tuple[List[List[str]], float]:
    """DP over contiguous splits of ``ops`` (a chain slice, in chain order)
    onto ``device_order``, minimizing Eq. 3's steady-state pace
    ``max_k max(C_k, R_k)``.  Returns raw segments (no source attachment).

    R_k is the time stage k spends receiving its boundary activation from
    stage k-1 over the (device_order[k-1] -> device_order[k]) link; the
    boundary edge is the op pair straddling the cut, and its bytes/seconds
    come from the unified ``cost_model`` — so a compression-plan-bearing
    model re-cuts under *compressed* costs, which replaced the old
    stage-indexed ``edge_bytes_scale`` hack.

    ``inbound = (producer_op, src_device)`` charges stage 0 for receiving
    ``producer_op``'s boundary from ``src_device`` — used by the
    boundary-pinned elastic re-cut, where a sub-chain's first stage still
    pays for the (frozen) cross-cluster edge feeding it.

    DP state: best[i][k] = minimal pace for placing first i ops on first k+1
    devices.  O(n² · d) — fine for n ≤ a few thousand ops.
    """
    order = list(ops)
    n = len(order)
    d = len(device_order)
    if d > n:
        raise ValueError(f"{d} stages > {n} ops")
    flops = np.array([profiles[m].fwd_flops for m in order], dtype=np.float64)
    pre = np.concatenate([[0.0], np.cumsum(flops)])
    # boundary edge at cut position i: producer order[i-1] -> consumer
    # order[i]; transport seconds for every stage pair, precomputed once
    recv_cache: Dict[Tuple[int, int], float] = {}

    def comp_time(i: int, j: int, k: int) -> float:  # ops [i,j) on stage k
        return (pre[j] - pre[i]) / cluster.devices[device_order[k]].speed

    def recv_time(i: int, k: int) -> float:  # boundary into stage k at op i
        if k == 0:
            if inbound is None or i != 0:
                return 0.0
            prod, src = inbound
            return cost_model.edge_seconds(prod, order[0], src,
                                           device_order[0])
        if i == 0:
            return 0.0
        key = (i, k)
        if key not in recv_cache:
            recv_cache[key] = cost_model.edge_seconds(
                order[i - 1], order[i],
                device_order[k - 1], device_order[k])
        return recv_cache[key]

    INF = float("inf")
    best = np.full((n + 1, d), INF)
    back = np.full((n + 1, d), -1, dtype=np.int64)
    for j in range(1, n - d + 2):
        best[j][0] = max(comp_time(0, j, 0), recv_time(0, 0))
    for k in range(1, d):
        for j in range(k + 1, n - (d - 1 - k) + 1):
            for i in range(k, j):
                if best[i][k - 1] == INF:
                    continue
                pace = max(best[i][k - 1],
                           comp_time(i, j, k),
                           recv_time(i, k))
                if pace < best[j][k]:
                    best[j][k] = pace
                    back[j][k] = i
    if best[n][d - 1] == INF:
        raise RuntimeError("DP found no feasible split")
    cuts: List[int] = [n]
    j, k = n, d - 1
    while k > 0:
        j = int(back[j][k])
        cuts.append(j)
        k -= 1
    cuts = sorted(cuts)
    return _segments_to_assignment(order, cuts), float(best[n][d - 1])


def partition_min_bottleneck(graph: OpGraph, profiles: Mapping[str, OpProfile],
                             cluster: ClusterSpec,
                             device_order: Sequence[int],
                             cost_model=None,
                             ) -> Tuple[List[List[str]], float]:
    """Min-bottleneck DP over the whole op chain (see
    :func:`min_bottleneck_chain`), with placeholders/variables attached to
    their consumers' segments.  ``cost_model`` defaults to dense transport;
    pass a plan-bearing :class:`repro_torch.core.costmodel.EdgeCostModel` to cut
    under compressed byte costs (the OP-Fence/AdaTopK co-planner does)."""
    if cost_model is None:
        from .costmodel import EdgeCostModel   # late: costmodel imports core
        cost_model = EdgeCostModel(graph, profiles, cluster)
    segs, pace = min_bottleneck_chain(chain(graph), profiles, cluster,
                                      device_order, cost_model)
    return attach_sources(graph, segs), pace
