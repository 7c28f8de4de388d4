"""What-if engine: re-price a recorded scenario under counterfactual edits.

The blame table (:mod:`repro_torch.obs.critpath`) names the bottleneck; this
module answers the follow-up question — *which fix pays most?* — by
replaying the same scenario through
:func:`repro_torch.core.executor.simulate_iteration` under counterfactual
edits expressed through :class:`repro_torch.core.costmodel.
EdgeCostModel` variants:

* ``link_speedup`` — a directed link ``k``× faster (a calibrated
  ``link_corrections`` entry divided by ``k``: the exact channel the
  closed-loop calibrator uses, so a what-if "restore the degraded wire"
  prices identically to the controller adopting the fitted correction);
* ``node_links_speedup`` — every link touching a node ``k``× faster (the
  counterfactual for "this volunteer's uplink recovered");
* ``codec_free`` — compression codec priced at zero
  (``with_kernel_costs({})``, as if encoding cost no compute);
* ``ratio_change`` — re-run AdaTopK at a different target ratio on the same
  placement and transport under the new plan;
* ``drop_device`` — remove a device and re-plan on the survivors
  (``device_subset``), the counterfactual behind the elastic controller's
  leave handling.

:func:`rank` prices each intervention with the discrete-event simulator
itself — predictions are *exact* by construction for cost-model edits (the
sim consumes the same :class:`EdgeCostModel`); a 5% bound only absorbs α/β
asymmetries when a counterfactual is compared against a ground-truth
cluster edit (``with_link_slowdowns`` scales β only, while a
correction scales the whole link time).

No byte arithmetic happens here: every counterfactual is an
``EdgeCostModel`` variant, never a hand-scaled β.
"""
from __future__ import annotations

import dataclasses
import re
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

_LINK_TRACK_RE = re.compile(r"^link (\d+)->(\d+)$")


@dataclasses.dataclass
class Scenario:
    """Everything needed to re-simulate one recorded training step.

    ``cost_model`` carries the calibrated link corrections / kernel costs in
    force when the trace was recorded; ``cluster`` is the (believed or true)
    cluster the step priced against.  Build one from an
    :class:`~repro_torch.core.scheduler.JointPlan` with :meth:`from_joint`.
    """

    graph: Any
    profiles: Mapping[str, Any]
    schedule: Any
    cluster: Any
    plan: Optional[Any] = None
    cost_model: Optional[Any] = None
    n_micro: int = 1

    @classmethod
    def from_joint(cls, graph, profiles, cluster, joint, n_micro: int = 1
                   ) -> "Scenario":
        return cls(graph=graph, profiles=profiles, schedule=joint.schedule,
                   cluster=cluster, plan=joint.plan,
                   cost_model=joint.cost_model, n_micro=n_micro)

    def model(self):
        """The scenario's effective cost model (built lazily if absent)."""
        if self.cost_model is not None:
            return self.cost_model
        from repro_torch.core.costmodel import EdgeCostModel
        return EdgeCostModel(self.graph, self.profiles, self.cluster,
                             plan=self.plan)

    def price(self) -> float:
        """Step seconds under this scenario — the simulator's ground truth."""
        from repro_torch.core.executor import simulate_iteration
        sim = simulate_iteration(self.graph, self.profiles, self.schedule,
                                 self.cluster, plan=self.plan,
                                 n_micro=self.n_micro,
                                 cost_model=self.model())
        return float(sim.iteration_time)


@dataclasses.dataclass(frozen=True)
class Intervention:
    """One named counterfactual edit: ``apply(scenario) -> scenario``."""

    name: str
    detail: str
    apply: Callable[[Scenario], Scenario]


@dataclasses.dataclass(frozen=True)
class WhatIfResult:
    """One priced intervention, comparable against the recorded baseline."""

    name: str
    detail: str
    baseline_seconds: float
    predicted_seconds: float

    @property
    def delta_seconds(self) -> float:
        return self.baseline_seconds - self.predicted_seconds

    @property
    def speedup(self) -> float:
        if self.predicted_seconds <= 0.0:
            return float("inf")
        return self.baseline_seconds / self.predicted_seconds

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "detail": self.detail,
                "baseline_seconds": self.baseline_seconds,
                "predicted_seconds": self.predicted_seconds,
                "delta_seconds": self.delta_seconds,
                "speedup": self.speedup}


# ------------------------------------------------------------ edit builders --
def _scaled_corrections(model, pairs: Sequence[Tuple[int, int]],
                        factor: float) -> Dict[Tuple[int, int], float]:
    corr = dict(model.link_corrections)
    for pair in pairs:
        corr[pair] = corr.get(pair, 1.0) * factor
    return corr


def link_speedup(src: int, dst: int, k: float = 2.0) -> Intervention:
    """Directed link ``src -> dst`` priced ``k``× faster."""
    def _apply(sc: Scenario) -> Scenario:
        model = sc.model()
        corr = _scaled_corrections(model, [(src, dst)], 1.0 / k)
        return dataclasses.replace(
            sc, cost_model=model.with_link_corrections(corr))
    return Intervention(name=f"link {src}->{dst} {k:g}x",
                        detail=f"price directed link {src}->{dst} {k:g}x "
                               f"faster via a link correction",
                        apply=_apply)


def node_links_speedup(node: int, k: float = 2.0,
                       peers: Optional[Sequence[int]] = None) -> Intervention:
    """Every directed link touching ``node`` priced ``k``× faster (both
    directions, against ``peers`` or every other device in the cluster)."""
    def _apply(sc: Scenario) -> Scenario:
        model = sc.model()
        others = list(peers) if peers is not None \
            else [d for d in range(len(sc.cluster)) if d != node]
        pairs = [(node, p) for p in others] + [(p, node) for p in others]
        corr = _scaled_corrections(model, pairs, 1.0 / k)
        return dataclasses.replace(
            sc, cost_model=model.with_link_corrections(corr))
    return Intervention(name=f"node {node} links {k:g}x",
                        detail=f"price every link touching node {node} "
                               f"{k:g}x faster",
                        apply=_apply)


def codec_free() -> Intervention:
    """Compression codec priced at zero (drop all fitted kernel costs)."""
    def _apply(sc: Scenario) -> Scenario:
        return dataclasses.replace(sc, cost_model=sc.model().with_kernel_costs({}))
    return Intervention(name="codec free",
                        detail="price the compression codec at zero seconds",
                        apply=_apply)


def ratio_change(ratio: float) -> Intervention:
    """Re-run AdaTopK at ``ratio`` on the *same* placement and transport
    under the resulting plan."""
    def _apply(sc: Scenario) -> Scenario:
        from repro_torch.core.compression import plan_adatopk
        model = sc.model()
        plan = plan_adatopk(sc.graph, sc.profiles, sc.cluster,
                            sc.schedule.placement, float(ratio),
                            cost_model=model.with_plan(None))
        return dataclasses.replace(sc, plan=plan,
                                   cost_model=model.with_plan(plan))
    return Intervention(name=f"ratio {ratio:g}",
                        detail=f"re-plan AdaTopK at target ratio {ratio:g} "
                               f"on the recorded placement",
                        apply=_apply)


def drop_device(dev: int, ratio: Optional[float] = None) -> Intervention:
    """Remove a device and re-plan the pipeline on the survivors (joint
    re-plan when the scenario compresses, plain OP-Fence otherwise)."""
    def _apply(sc: Scenario) -> Scenario:
        survivors = [d for d in range(len(sc.cluster)) if d != dev]
        model = sc.model()
        base = model.with_plan(None)
        r = ratio if ratio is not None \
            else (sc.plan.base_ratio if sc.plan is not None else None)
        if r is not None and r > 1.0:
            from repro_torch.core.scheduler import schedule_joint
            joint = schedule_joint(sc.graph, sc.profiles, sc.cluster,
                                   float(r), device_subset=survivors,
                                   cost_model=base)
            return dataclasses.replace(sc, schedule=joint.schedule,
                                       plan=joint.plan,
                                       cost_model=joint.cost_model)
        from repro_torch.core.scheduler import schedule_opfence
        sched = schedule_opfence(sc.graph, sc.profiles, sc.cluster,
                                 cost_model=base, device_subset=survivors)
        return dataclasses.replace(sc, schedule=sched, plan=None,
                                   cost_model=base)
    return Intervention(name=f"drop dev{dev}",
                        detail=f"remove device {dev} and re-plan on the "
                               f"survivors",
                        apply=_apply)


# ----------------------------------------------------------------- ranking --
def rank(scenario: Scenario,
         interventions: Sequence[Intervention]) -> List[WhatIfResult]:
    """Price every intervention against the scenario baseline and return
    results best-first (largest predicted step-time reduction)."""
    baseline = scenario.price()
    out: List[WhatIfResult] = []
    for iv in interventions:
        predicted = iv.apply(scenario).price()
        out.append(WhatIfResult(name=iv.name, detail=iv.detail,
                                baseline_seconds=baseline,
                                predicted_seconds=predicted))
    out.sort(key=lambda r: (r.predicted_seconds, r.name))
    return out


def default_interventions(scenario: Scenario, blame_rows: Sequence[Any],
                          k: float = 2.0, top: int = 4
                          ) -> List[Intervention]:
    """Candidate fixes suggested by a blame table: a ``k``× speedup for each
    of the worst ``top`` critical-path links, plus ``codec free`` whenever
    codec time appears on the path, plus a 2× coarser / 2× finer AdaTopK
    ratio when the scenario compresses."""
    out: List[Intervention] = []
    n_links = 0
    saw_codec = False
    for row in blame_rows:
        if row.kind == "wire" and n_links < top:
            m = _LINK_TRACK_RE.match(row.track)
            if m:
                out.append(link_speedup(int(m.group(1)), int(m.group(2)), k))
                n_links += 1
        elif row.kind == "codec" and not saw_codec:
            saw_codec = True
            out.append(codec_free())
    if scenario.plan is not None and scenario.plan.base_ratio > 1.0:
        base = float(scenario.plan.base_ratio)
        out.append(ratio_change(base * 2.0))
        if base > 2.0:
            out.append(ratio_change(base / 2.0))
    return out
