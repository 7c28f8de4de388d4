"""Serving plan: stage split + replica placement over the membership view.

``plan_serving`` turns "which nodes are alive" into "who hosts which stage":

* split the decoder into ``n_stages`` contiguous layer runs
  (:func:`repro_torch.serving.stages.split_stages`);
* deal the alive devices across stages round-robin in descending
  ``DeviceSpec.speed`` order, so every stage gets a replica before any gets
  two and fast devices spread instead of clustering (Petals servers pick the
  most-wanted block range; our planner is the centralized equivalent);
* gate each assignment on **KV-cache placement feasibility** priced by
  :class:`repro_torch.serving.costs.ServingCostModel`: resident stage weights +
  ``max_batch`` session slots of KV at ``cache_len`` must fit the device's
  ``mem_bytes``.  An infeasible swarm raises :class:`ServingPlanError` with
  the exact byte arithmetic in the message, it never silently over-commits.

The plan is static per membership epoch; the router
(:mod:`repro_torch.serving.router`) handles per-session choice *within* the
replica sets and mid-session re-routing when a replica dies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelCfg

from .costs import ServingCostModel
from .stages import StageSpec, split_stages


class ServingPlanError(ValueError):
    """The swarm cannot host the model (no devices, or memory infeasible)."""


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Immutable placement: which devices replicate which stage."""

    cfg: ModelCfg
    stages: List[StageSpec]
    replicas: Dict[int, List[int]]       # stage index -> device ids
    cache_len: int
    max_batch: int                       # concurrent sessions per replica
    costs: ServingCostModel

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def devices(self) -> List[int]:
        return sorted({d for ds in self.replicas.values() for d in ds})

    def stage_of(self, device: int) -> Optional[int]:
        for s, ds in self.replicas.items():
            if device in ds:
                return s
        return None

    def describe(self) -> str:
        lines = [f"serving plan: {self.n_stages} stages, "
                 f"cache_len={self.cache_len}, max_batch={self.max_batch}"]
        for spec in self.stages:
            ds = self.replicas[spec.index]
            kvb = self.costs.kv_bytes(spec, self.cache_len)
            lines.append(f"  {spec}: replicas={ds} "
                         f"kv/slot={kvb} B params="
                         f"{self.costs.stage_param_bytes(spec)} B")
        return "\n".join(lines)


def _check_memory(costs: ServingCostModel, spec: StageSpec, device: int,
                  cache_len: int, max_batch: int) -> None:
    need = costs.stage_param_bytes(spec) \
        + max_batch * costs.kv_bytes(spec, cache_len)
    have = costs.cluster.devices[device].mem_bytes
    if need > have:
        raise ServingPlanError(
            f"device {device} cannot host {spec}: needs {need} B "
            f"(params {costs.stage_param_bytes(spec)} + {max_batch} slots × "
            f"{costs.kv_bytes(spec, cache_len)} B KV) "
            f"but has {have:.3g} B — lower max_batch/cache_len or add stages")


def plan_serving(cfg: ModelCfg, costs: ServingCostModel,
                 alive: Sequence[int], n_stages: int,
                 cache_len: int, max_batch: int = 4) -> ServingPlan:
    """Place ``n_stages`` stage replicas on the ``alive`` devices.

    Every stage must end up with at least one replica, so
    ``len(alive) >= n_stages``; extra devices become additional replicas,
    fastest-first round-robin so replica counts differ by at most one.
    """
    alive = sorted(set(alive))
    if not alive:
        raise ServingPlanError("no alive devices to serve on")
    if len(alive) < n_stages:
        raise ServingPlanError(
            f"{len(alive)} alive devices cannot host {n_stages} stages "
            "(need >= 1 replica per stage)")
    specs = split_stages(cfg, n_stages)

    by_speed = sorted(alive,
                      key=lambda d: (-costs.cluster.devices[d].speed, d))
    replicas: Dict[int, List[int]] = {s.index: [] for s in specs}
    for i, dev in enumerate(by_speed):
        spec = specs[i % n_stages]
        _check_memory(costs, spec, dev, cache_len, max_batch)
        replicas[spec.index].append(dev)
    for s in replicas:
        replicas[s].sort()
    return ServingPlan(cfg=cfg, stages=specs, replicas=replicas,
                       cache_len=int(cache_len), max_batch=int(max_batch),
                       costs=costs)
