"""Throughput model (FusionLLM §3.6, Eq. 2–4; §5.2, Eq. 8).

Per-CompNode totals under an assignment A:
    C_p = Σ_{k∈A_p} Σ_{f∈S_k} C(f,p)
    R_p = Σ_{k∈A_p} Σ_{f∈S_k, P(f)≠P(Pa(f))} R(Pa(f))

single-pass latency       T_lat   = Σ_p (C_p + R_p)                     (Eq. 2)
pipelined (n_b batches)   T_pipe  = Σ_p (C_p + R_p) + (n_b-1)·max_p max(C_p,R_p)  (Eq. 3)
throughput                φ       = N_s / T_pipe                         (Eq. 4)
adaptive compression      ~T_pipe = Σ_p (C_p + 3·R_p/r_i) + 3(n_b-1)·max_p(C_p,R_p)/r   (Eq. 8)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .estimator import ClusterSpec, OpCost, estimate_op_costs
from .opgraph import OpGraph, OpProfile


@dataclasses.dataclass(frozen=True)
class NodeLoad:
    """Per-CompNode (C_p, R_p) pair."""

    comp: float      # C_p
    recv: float      # R_p

    @property
    def total(self) -> float:
        return self.comp + self.recv

    @property
    def bottleneck(self) -> float:
        """max(C_p, R_p) — with compute/communication overlap a CompNode's
        steady-state stage time is whichever dominates (paper Eq. 3)."""
        return max(self.comp, self.recv)


def node_loads(op_costs: Mapping[str, OpCost],
               placement: Mapping[str, int],
               n_nodes: int) -> List[NodeLoad]:
    comp = [0.0] * n_nodes
    recv = [0.0] * n_nodes
    for name, cost in op_costs.items():
        p = placement[name]
        comp[p] += cost.comp_time
        recv[p] += cost.recv_time
    return [NodeLoad(comp=c, recv=r) for c, r in zip(comp, recv)]


def latency_single_pass(loads: Sequence[NodeLoad]) -> float:
    """Eq. 2 — one forward pass of the whole graph, sequential stages."""
    return sum(l.total for l in loads)


def latency_pipelined(loads: Sequence[NodeLoad], n_micro: int) -> float:
    """Eq. 3 — GPipe-style: fill/drain once, then the slowest stage paces
    the remaining (n_b - 1) micro-batches."""
    if n_micro < 1:
        raise ValueError("n_micro >= 1")
    fill = sum(l.total for l in loads)
    pace = max((l.bottleneck for l in loads), default=0.0)
    return fill + (n_micro - 1) * pace


def throughput(loads: Sequence[NodeLoad], n_micro: int, batch_size: int) -> float:
    """Eq. 4 — samples/second."""
    t = latency_pipelined(loads, n_micro)
    return batch_size / t if t > 0 else float("inf")


@dataclasses.dataclass(frozen=True)
class IterationEstimate:
    """Full FP+BP iteration estimate for a placement."""

    fwd_loads: Tuple[NodeLoad, ...]
    bwd_loads: Tuple[NodeLoad, ...]
    n_micro: int
    batch_size: int

    @property
    def fwd_time(self) -> float:
        return latency_pipelined(self.fwd_loads, self.n_micro)

    @property
    def bwd_time(self) -> float:
        return latency_pipelined(self.bwd_loads, self.n_micro)

    @property
    def iteration_time(self) -> float:
        return self.fwd_time + self.bwd_time

    @property
    def samples_per_sec(self) -> float:
        return self.batch_size / self.iteration_time


def estimate_iteration(graph: OpGraph,
                       profiles: Mapping[str, OpProfile],
                       cluster: ClusterSpec,
                       placement: Mapping[str, int],
                       n_micro: int,
                       batch_size: int,
                       cost_model=None) -> IterationEstimate:
    """End-to-end Eq. 2–4 (and, with a plan-bearing ``cost_model``, Eq. 8)
    estimate.

    BP communication mirrors FP (boundary gradients have the same size as the
    forward activations they correspond to) and BP compute uses the standard
    2× forward approximation — both per the paper's symmetric DAG treatment.
    Compression enters through the unified
    :class:`repro_torch.core.costmodel.EdgeCostModel` (exact wire encoding), which
    replaced the removed smooth ``compress_ratio`` approximation.
    """
    fwd = estimate_op_costs(graph, profiles, cluster, placement,
                            cost_model, backward=False)
    bwd = estimate_op_costs(graph, profiles, cluster, placement,
                            cost_model, backward=True)
    n = len(cluster)
    return IterationEstimate(
        fwd_loads=tuple(node_loads(fwd, placement, n)),
        bwd_loads=tuple(node_loads(bwd, placement, n)),
        n_micro=n_micro, batch_size=batch_size)


def peak_activation_bytes(graph: OpGraph, profiles: Mapping[str, OpProfile],
                          placement: Mapping[str, int], n_nodes: int,
                          n_micro: int) -> List[int]:
    """Per-CompNode activation footprint: every op's output is held for BP,
    for every in-flight micro-batch (GPipe holds all n_b)."""
    acc = [0] * n_nodes
    for name, prof in profiles.items():
        acc[placement[name]] += prof.out_bytes
    return [a * n_micro for a in acc]


def memory_feasible(graph: OpGraph, profiles: Mapping[str, OpProfile],
                    cluster: ClusterSpec, placement: Mapping[str, int],
                    n_micro: int, optimizer_state_mult: float = 2.0) -> bool:
    """Constraint (6): params + optimizer state + activations fit D^p_gpu."""
    n = len(cluster)
    param_b = [0.0] * n
    for name, prof in profiles.items():
        param_b[placement[name]] += prof.param_bytes
    act_b = peak_activation_bytes(graph, profiles, placement, n, n_micro)
    for p in range(n):
        need = param_b[p] * (1.0 + 1.0 + optimizer_state_mult) + act_b[p]
        if need > cluster.devices[p].mem_bytes:
            return False
    return True
