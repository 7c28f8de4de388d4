"""Incremental re-scheduling + migration planning (elastic runtime).

On a membership epoch change the broker re-runs OP-Fence on the surviving /
updated topology (``schedule_opfence(..., device_subset=alive)``), diffs the
old and new stage assignments, and emits the *minimal* migration plan: only
ops whose owner changed move, each carrying its parameters plus optimizer
state.  Transfer cost is estimated over the real α–β link specs by the
discrete-event :func:`repro_torch.core.executor.simulate_migration`; ops stranded
on a dead CompNode stream from the broker's checkpoint store instead (a dead
node cannot send).

Migration payloads are never lossy-compressed: AdaTopK is for per-step
boundary tensors where error feedback and training itself absorb the loss;
migrated parameters/optimizer state must land bit-exact or the loss curve
jumps (see migrate.py).

``pin_boundaries=True`` hardens the anchored candidate: segment boundaries
are frozen at the old schedule's inter-cluster (WAN) cuts, and the DP re-cut
runs independently inside each bandwidth cluster — so no op (hence no
parameter/optimizer shard) ever migrates across a WAN link, the exact
traffic class overlapped migration cannot hide (the stream rides the same
wire the pipeline is bottlenecked by).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.costmodel import EdgeCostModel
from repro_torch.core.estimator import ClusterSpec, LinkSpec
from repro_torch.core.executor import (CHECKPOINT_LINK, MigrationSim,
                                 simulate_migration)
from repro_torch.core.opgraph import OpGraph, OpProfile
from repro_torch.core.opgraph import chain as op_chain
from repro_torch.core.partition import (attach_sources, min_bottleneck_chain,
                                  partition_min_bottleneck)
from repro_torch.core.scheduler import (Schedule, _to_full_assignment,
                                  louvain_communities, schedule_joint,
                                  schedule_opfence)


@dataclasses.dataclass(frozen=True)
class OpMove:
    """One op segment changing owner.  ``src=None`` — original owner dead,
    state comes from the broker's checkpoint store."""

    op: str
    src: Optional[int]
    dst: int
    nbytes: int          # params + optimizer state on the wire

    @property
    def from_checkpoint(self) -> bool:
        return self.src is None


@dataclasses.dataclass
class MigrationPlan:
    """Diff between two schedules, grouped into per-link bulk transfers."""

    moves: List[OpMove]
    sim: MigrationSim

    @property
    def total_bytes(self) -> float:
        return float(sum(m.nbytes for m in self.moves))

    @property
    def seconds(self) -> float:
        return self.sim.seconds

    def transfers(self) -> Dict[Tuple[Optional[int], int], float]:
        return _group_transfers(self.moves)


@dataclasses.dataclass
class ReplanResult:
    schedule: Schedule
    migration: MigrationPlan
    alive: List[int]
    dead: List[int]
    mode: str = "full"           # which candidate won: full | anchored | keep
    # every candidate as priced by the migration-aware choice, in scoring
    # order: {name, pace, migration_bytes, migration_seconds, score, winner}.
    # Plain dicts (not obs dataclasses) so this layer stays import-light; the
    # controller's flight recorder lifts them into CandidateScore records.
    scores: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


def state_bytes(profile: OpProfile, opt_state_mult: float = 2.0,
                param_itemsize: int = 4) -> int:
    """Wire bytes to relocate one op: params + optimizer state (AdamW keeps
    two fp32 moments per parameter -> mult 2.0; SGD momentum 1.0)."""
    return int(profile.n_params * param_itemsize * (1.0 + opt_state_mult))


def diff_schedules(old: Schedule, new: Schedule,
                   profiles: Mapping[str, OpProfile],
                   dead: Sequence[int] = (),
                   opt_state_mult: float = 2.0) -> List[OpMove]:
    """Ops whose owner changed, in graph order.  Ops with no trainable state
    (placeholders, activations-only ops) still move but cost zero bytes —
    re-binding ownership is a control-plane action."""
    dead_set = set(int(d) for d in dead)
    old_place, new_place = old.placement, new.placement
    moves: List[OpMove] = []
    for op, src in old_place.items():
        dst = new_place.get(op)
        if dst is None or dst == src:
            continue
        nbytes = state_bytes(profiles[op], opt_state_mult) \
            if op in profiles else 0
        moves.append(OpMove(op=op, src=None if src in dead_set else src,
                            dst=dst, nbytes=nbytes))
    return moves


def _group_transfers(moves: Sequence[OpMove]
                     ) -> Dict[Tuple[Optional[int], int], float]:
    out: Dict[Tuple[Optional[int], int], float] = {}
    for m in moves:
        key = (m.src, m.dst)
        out[key] = out.get(key, 0.0) + float(m.nbytes)
    return out


def interim_schedule(graph: OpGraph, old: Schedule, dead: Sequence[int],
                     n_devices: int) -> Optional[Schedule]:
    """Cheapest runnable schedule after a failure (overlapped migration).

    The old schedule with each dead stage's op segment merged into an
    adjacent *surviving* stage (the predecessor when one exists, else the
    first survivor downstream).  Segments are contiguous chain runs in stage
    order, so merging a run into its neighbour keeps every stage's sub-DAG
    connected.  Only the dead segments' state must stream in (from the
    broker's checkpoint store) before training resumes on this schedule;
    every other op stays put — the rest of the re-plan drains in the
    background.  Returns None when no stage survives.
    """
    dead_set = {int(d) for d in dead}
    out_devs: List[int] = []
    out_segs: List[List[str]] = []
    pending: List[str] = []    # dead segments preceding the first survivor
    for dev in old.stage_devices():
        seg = list(old.assignment[dev])
        if dev in dead_set:
            if out_segs:
                out_segs[-1].extend(seg)
            else:
                pending.extend(seg)
        else:
            out_devs.append(dev)
            out_segs.append(pending + seg)
            pending = []
    if not out_devs:
        return None
    a, s = _to_full_assignment(out_segs, out_devs, n_devices)
    return Schedule(assignment=a, stages=s, clusters=old.clusters)


def _anchored_schedule(graph: OpGraph, profiles: Mapping[str, OpProfile],
                       cluster: ClusterSpec, old_schedule: Schedule,
                       alive: Sequence[int], joined: Sequence[int],
                       cost_model: Optional[EdgeCostModel]
                       ) -> Optional[Schedule]:
    """Stability-preferring candidate: keep the surviving stage order from
    the old schedule (append joiners at the tail) and re-run only the DP
    split.  Most segment boundaries barely move, so the migration diff stays
    near the dead node's own shard instead of reshuffling the whole model —
    a fresh OP-Fence pass re-cuts every boundary and can move everything.
    """
    alive_set = set(int(a) for a in alive)
    order = [d for d in old_schedule.stage_devices() if d in alive_set]
    order += [int(j) for j in joined
              if j in alive_set and j not in set(order)]
    n_ops = len(op_chain(graph))
    order = order[:max(1, min(len(order), n_ops))]
    if not order:
        return None
    segs, pace = partition_min_bottleneck(graph, profiles, cluster, order,
                                          cost_model=cost_model)
    a, s = _to_full_assignment(segs, order, len(cluster))
    return Schedule(assignment=a, stages=s, clusters=old_schedule.clusters,
                    predicted_pace=pace)


def _communities_for(cluster: ClusterSpec,
                     old_schedule: Schedule) -> List[List[int]]:
    """Bandwidth communities the WAN fences sit between: the old schedule's
    Louvain clusters when recorded, else a fresh Louvain pass over the full
    bandwidth matrix (devices the schedule never saw land in their natural
    community)."""
    if old_schedule.clusters:
        return [list(c) for c in old_schedule.clusters]
    return louvain_communities(cluster.bandwidth_matrix())


def _extend_communities(cluster: ClusterSpec,
                        communities: List[List[int]],
                        devices: Sequence[int]) -> List[List[int]]:
    """Map devices absent from the recorded communities (the old schedule
    was cut on a survivor subset) into the recorded community their
    full-matrix Louvain community overlaps most — i.e. the site they
    physically sit in.  A device whose full community shares no member with
    any recorded one belongs to a genuinely unseen site and stays unmapped
    (the caller must not place it: there is no fence to keep it behind)."""
    known = {d for c in communities for d in c}
    missing = [int(d) for d in devices if int(d) not in known]
    if not missing:
        return communities
    full = louvain_communities(cluster.bandwidth_matrix())
    out = [list(c) for c in communities]
    for d in missing:
        fc = next((set(c) for c in full if d in c), set())
        overlap, best = 0, None
        for ci, c in enumerate(out):
            ov = len(fc & set(c) & known)
            if ov > overlap:
                overlap, best = ov, ci
        if best is not None:
            out[best].append(d)
    return out


def cross_cluster_bytes(moves: Sequence[OpMove],
                        communities: Sequence[Sequence[int]]) -> float:
    """Migration bytes that ride an inter-cluster (WAN) link.  Checkpoint
    streams (``src=None``) are excluded — the broker store is not a WAN
    peer, and a dead node's shard has to stream from it regardless.  A
    device absent from ``communities`` cannot be proven co-located with
    anything, so transfers touching it count as crossing (conservative:
    this metric must never under-report the traffic pinning forbids)."""
    comm_of = {d: ci for ci, c in enumerate(communities) for d in c}

    def crosses(m: OpMove) -> bool:
        cs, cd = comm_of.get(m.src), comm_of.get(m.dst)
        return cs is None or cd is None or cs != cd

    return float(sum(m.nbytes for m in moves
                     if m.src is not None and crosses(m)))


def _pinned_anchored_schedule(graph: OpGraph,
                              profiles: Mapping[str, OpProfile],
                              cluster: ClusterSpec, old_schedule: Schedule,
                              alive: Sequence[int], joined: Sequence[int],
                              cost_model: Optional[EdgeCostModel]
                              ) -> Optional[Schedule]:
    """Boundary-pinned anchored candidate (closes the ROADMAP open item).

    The plain anchored candidate re-runs one DP over the whole chain, so a
    segment boundary can drift across the inter-cluster WAN link — exactly
    the migration traffic that cannot be hidden by overlapping (the bulk
    stream contends with the pipeline's own bottleneck wire).  Here the old
    schedule's cut positions at community boundaries are *frozen*: the chain
    is sliced at every point where consecutive old stages sit in different
    bandwidth clusters, surviving devices keep their old order inside each
    slice, and the min-bottleneck DP re-cuts each slice independently
    (charging the first stage of a slice for the pinned WAN edge feeding
    it).  Every op therefore stays inside its old community — zero
    cross-cluster migration bytes by construction.  A community whose
    devices all died merges its slice into the previous (else next) slice:
    that traffic is unavoidable.
    """
    if cost_model is None:
        cost_model = EdgeCostModel(graph, profiles, cluster)
    alive_set = set(int(a) for a in alive)
    communities = _extend_communities(
        cluster, _communities_for(cluster, old_schedule), joined)
    comm_of = {d: ci for ci, c in enumerate(communities) for d in c}
    order = list(op_chain(graph))
    pos = {op: i for i, op in enumerate(order)}

    # community runs over the old stage order, each with its chain slice
    runs: List[Dict[str, Any]] = []   # {comm, devices(alive), n_ops}
    for dev in old_schedule.stage_devices():
        n_ops = sum(1 for op in old_schedule.assignment[dev] if op in pos)
        c = comm_of.get(dev)
        if not runs or runs[-1]["comm"] != c:
            runs.append({"comm": c, "devices": [], "n_ops": 0})
        runs[-1]["n_ops"] += n_ops
        if dev in alive_set:
            runs[-1]["devices"].append(dev)
    if not runs:
        return None
    # joiners ride with their own community's run — only.  Unrecorded
    # joiners were mapped into the recorded community their site overlaps
    # (``_extend_communities``); one from a genuinely unseen site, or whose
    # community holds no pipeline slice, is *not* placed here: feeding it
    # state would cross a community boundary, the exact traffic class
    # pinning exists to forbid.  Under a pinned controller such a device
    # stays idle until the operator re-plans un-pinned — by construction
    # there is no fence-respecting way to stream state to it.
    seen = {d for r in runs for d in r["devices"]}
    for j in joined:
        j = int(j)
        if j not in alive_set or j in seen:
            continue
        host = next((r for r in runs if r["comm"] == comm_of.get(j)
                     and comm_of.get(j) is not None), None)
        if host is None:
            continue
        host["devices"].append(j)
        seen.add(j)
    # a run whose devices all died merges into its predecessor (else
    # successor) — cross-WAN movement of that slice is unavoidable
    merged: List[Dict[str, Any]] = []
    for r in runs:
        if r["devices"] or not merged:
            merged.append(r)
        else:
            merged[-1]["n_ops"] += r["n_ops"]
    while merged and not merged[0]["devices"]:
        if len(merged) == 1:
            return None
        merged[1]["n_ops"] += merged[0]["n_ops"]
        merged.pop(0)

    segments: List[List[str]] = []
    stage_devs: List[int] = []
    pace = 0.0
    lo = 0
    prev_dev: Optional[int] = None
    for r in merged:
        hi = lo + r["n_ops"]
        ops = order[lo:hi]
        if not ops:
            lo = hi
            continue
        devs = r["devices"][:len(ops)]
        inbound = (order[lo - 1], prev_dev) \
            if lo > 0 and prev_dev is not None else None
        segs, run_pace = min_bottleneck_chain(ops, profiles, cluster, devs,
                                              cost_model, inbound=inbound)
        segments.extend(segs)
        stage_devs.extend(devs)
        pace = max(pace, run_pace)
        prev_dev = devs[-1]
        lo = hi
    if not stage_devs:
        return None
    segments = attach_sources(graph, segments)
    a, s = _to_full_assignment(segments, stage_devs, len(cluster))
    return Schedule(assignment=a, stages=s, clusters=old_schedule.clusters,
                    predicted_pace=pace)


def replan(graph: OpGraph, profiles: Mapping[str, OpProfile],
           cluster: ClusterSpec, old_schedule: Schedule,
           alive: Sequence[int], dead: Sequence[int] = (),
           joined: Sequence[int] = (), seed: int = 0,
           opt_state_mult: float = 2.0,
           checkpoint_link: LinkSpec = CHECKPOINT_LINK,
           cost_model: Optional[EdgeCostModel] = None,
           mode: str = "auto", amortize_steps: float = 100.0,
           pin_boundaries: bool = False,
           planner: str = "opfence", joint_ratio: float = 100.0,
           verify: bool = True) -> ReplanResult:
    """Incremental re-scheduling with a migration-aware candidate choice.

    Two candidates: ``full`` re-runs OP-Fence from scratch on the survivors
    (best steady-state pace, potentially huge migration); ``anchored`` keeps
    the surviving stage order and only re-cuts the DP split (near-minimal
    migration, possibly worse pace).  ``mode='auto'`` picks the one with the
    lower total cost  ``migration_seconds + amortize_steps · pace`` — i.e.
    a pace advantage must pay back its migration bill within
    ``amortize_steps`` future micro-batches or stability wins.

    ``cluster`` is the broker's *believed* topology (degraded λ_p for flagged
    stragglers already folded in via ``network.with_slowdowns``); ``alive``
    restricts placement; ``dead`` marks nodes whose state is unrecoverable
    from the node itself; ``joined`` lists newly admitted CompNodes (the
    anchored candidate appends them at the pipeline tail).

    ``cost_model`` routes every byte account (DP re-cut, OP-Fence) through
    the unified :class:`repro_torch.core.costmodel.EdgeCostModel` — pass a
    plan-bearing model to re-plan under compressed edge costs.
    ``pin_boundaries=True`` replaces the anchored candidate's chain-wide DP
    with the boundary-pinned per-cluster form
    (:func:`_pinned_anchored_schedule`) **and drops the unconstrained
    ``full`` candidate** — a from-scratch OP-Fence pass moves state across
    the WAN freely, which would silently void the zero-cross-WAN guarantee
    the flag exists for (``mode='full'`` is therefore rejected).

    ``planner="joint"`` makes :func:`repro_torch.core.scheduler.schedule_joint`
    the ``full`` candidate generator — the OP-Fence × AdaTopK co-planner (at
    ``joint_ratio``) is then what actually produces epoch plans during
    training, not just a registry entry.  The anchored/pinned candidates
    already re-cut under ``cost_model``'s plan-bearing compressed costs, so
    the migration-aware choice compares like against like.

    When the old schedule is still feasible (no stage host dead or evicted),
    auto mode also offers it as the zero-migration ``keep`` candidate,
    re-scored under ``cost_model``.  Without it, a belief-change re-plan
    (straggler, calibration) is forced to move state even when every
    candidate's pace gain drowns in its migration bill — at GPT2-XL state
    sizes over WAN links the rational response to a degraded link is often
    "same cut, re-allocated compression", which costs zero bytes.
    """
    if mode not in ("auto", "full", "anchored"):
        raise ValueError(f"unknown replan mode {mode!r}")
    if planner not in ("opfence", "joint"):
        raise ValueError(f"unknown replan planner {planner!r}")
    if pin_boundaries and mode == "full":
        raise ValueError("pin_boundaries is incompatible with mode='full' — "
                         "the full re-plan cannot honor the pinned WAN cuts")
    candidates: Dict[str, Schedule] = {}
    alive_set = set(int(a) for a in alive)
    dead_set = set(int(d) for d in dead)
    old_devs = old_schedule.stage_devices()
    if mode == "auto" and old_devs and \
            all(d in alive_set and d not in dead_set for d in old_devs):
        # re-score against the CURRENT belief — the pace recorded at
        # original planning time predates whatever belief change (straggler,
        # calibration) triggered this re-plan, and a stale optimistic pace
        # plus a zero migration bill would let "keep" win the comparison the
        # re-plan exists to escape
        score_model = cost_model if cost_model is not None \
            else EdgeCostModel(graph, profiles, cluster)
        candidates["keep"] = dataclasses.replace(
            old_schedule, predicted_pace=score_model.stage_pace(old_schedule))
    if mode in ("auto", "anchored"):
        anchor_fn = _pinned_anchored_schedule if pin_boundaries \
            else _anchored_schedule
        anchored = anchor_fn(graph, profiles, cluster, old_schedule,
                             alive, joined, cost_model)
        if anchored is not None:
            candidates["anchored"] = anchored
    # the full candidate is suppressed while pinning EXCEPT as the auto-mode
    # fallback when no pinned candidate exists — that only happens when every
    # old stage host is gone, where all state comes from the checkpoint store
    # (src=None) and a fresh OP-Fence pass cannot move bytes across the WAN
    if mode in ("auto", "full") and \
            (not pin_boundaries or (mode == "auto" and not candidates)):
        if planner == "joint":
            candidates["full"] = schedule_joint(
                graph, profiles, cluster, ratio=joint_ratio, seed=seed,
                device_subset=alive, cost_model=cost_model,
                verify=False).schedule
        else:
            candidates["full"] = schedule_opfence(
                graph, profiles, cluster, seed=seed,
                cost_model=cost_model, device_subset=alive, verify=False)
    if not candidates:
        raise RuntimeError("no feasible re-plan candidate")

    best: Optional[Tuple[float, str, Schedule, List[OpMove], Any]] = None
    scores: List[Dict[str, Any]] = []
    for name, sched in sorted(candidates.items()):
        moves = diff_schedules(old_schedule, sched, profiles, dead=dead,
                               opt_state_mult=opt_state_mult)
        sim = simulate_migration(_group_transfers(moves), cluster,
                                 checkpoint_link=checkpoint_link)
        pace = sched.predicted_pace if sched.predicted_pace is not None \
            else float("inf")
        cost = sim.seconds + amortize_steps * pace
        scores.append({"name": name, "pace": pace,
                       "migration_bytes": float(sum(m.nbytes for m in moves)),
                       "migration_seconds": sim.seconds, "score": cost,
                       "winner": False})
        if best is None or cost < best[0]:
            best = (cost, name, sched, moves, sim)
    _, name, sched, moves, sim = best
    for s in scores:
        s["winner"] = s["name"] == name
    result = ReplanResult(schedule=sched,
                          migration=MigrationPlan(moves=moves, sim=sim),
                          alive=sorted(int(a) for a in alive),
                          dead=sorted(int(d) for d in dead), mode=name,
                          scores=scores)
    if verify:
        # static audit of the WINNING candidate only — the whole re-plan,
        # not each search state — so a diff/migration bug is rejected
        # before the controller ever installs it
        from repro_torch.check.elastic import verify_replan
        communities = None
        if pin_boundaries:
            communities = _extend_communities(
                cluster, _communities_for(cluster, old_schedule), joined)
        verify_replan(graph, profiles, result, old_schedule,
                      cluster=cluster, opt_state_mult=opt_state_mult,
                      pinned=pin_boundaries, communities=communities)
    return result
