"""Schedule checks (repro_torch.check, component 2).

A :class:`repro_torch.core.scheduler.Schedule` is only executable when

* every graph op is assigned to exactly one CompNode,
* each stage's compute ops form a contiguous run of :func:`chain` order
  and the runs appear in pipeline order (the GPipe executor and every
  Table-3 edge-set derivation assume it),
* the stage list is consistent (unique, in range, covering every
  non-empty CompNode) and every stage host is a member of the allowed
  device subset (the elastic runtime must never schedule onto the dead),
* each stage host can actually hold its shard: parameters + optimizer
  state + one micro-batch of activations within ``DeviceSpec.mem_bytes``.

:func:`verify_schedule` raises :class:`ScheduleCheckError` naming the
offending op/device.  The planners call it on every schedule they emit
(``verify=False`` opts out).
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

from repro_torch.core.estimator import ClusterSpec
from repro_torch.core.opgraph import OpGraph, OpProfile
from repro_torch.core.opgraph import chain as op_chain

from .errors import Finding, ScheduleCheckError, raise_findings


def _coverage_findings(graph: OpGraph, schedule) -> List[Finding]:
    out: List[Finding] = []
    owner: dict = {}
    for dev, seg in enumerate(schedule.assignment):
        for op in seg:
            if op not in graph.nodes:
                out.append(Finding("unknown-op", op,
                                   f"CompNode {dev} holds op {op!r} absent "
                                   "from the graph"))
            if op in owner:
                out.append(Finding(
                    "double-assignment", op,
                    f"op {op!r} assigned to CompNodes {owner[op]} and "
                    f"{dev}"))
            owner[op] = dev
    for op in graph.nodes:
        if op not in owner:
            out.append(Finding("unassigned-op", op,
                               f"op {op!r} is assigned to no CompNode"))
    return out


def _stage_findings(graph: OpGraph, schedule,
                    cluster: Optional[ClusterSpec],
                    alive: Optional[Sequence[int]]) -> List[Finding]:
    out: List[Finding] = []
    n_dev = len(schedule.assignment)
    seen: set = set()
    for d in schedule.stages:
        if not 0 <= d < n_dev:
            out.append(Finding("stage-out-of-range", f"dev{d}",
                               f"stage device {d} outside the {n_dev}-wide "
                               "assignment"))
            continue
        if d in seen:
            out.append(Finding("duplicate-stage", f"dev{d}",
                               f"device {d} listed twice in stages"))
        seen.add(d)
    for d, seg in enumerate(schedule.assignment):
        if seg and d not in seen:
            out.append(Finding(
                "stage-missing-device", f"dev{d}",
                f"CompNode {d} holds {seg[0]!r} (+{len(seg) - 1} more) but "
                "is absent from the stage order"))
    if cluster is not None and n_dev != len(cluster):
        out.append(Finding(
            "assignment-size", "<schedule>",
            f"assignment spans {n_dev} CompNodes but the cluster has "
            f"{len(cluster)}"))
    if alive is not None:
        alive_set = {int(a) for a in alive}
        for d in schedule.stage_devices():
            if d not in alive_set:
                seg = schedule.assignment[d]
                out.append(Finding(
                    "dead-device", f"dev{d}",
                    f"stage host {d} is outside the allowed subset "
                    f"(holds {seg[0]!r} (+{len(seg) - 1} more))"))
    if cluster is not None:
        hosts = [d for d in schedule.stage_devices() if 0 <= d < len(cluster)]
        for s, d in zip(hosts, hosts[1:]):
            try:
                cluster.link(s, d)
            except KeyError:
                out.append(Finding(
                    "missing-link", f"dev{s}->dev{d}",
                    f"consecutive stages on CompNodes {s} and {d} share no "
                    "link in the cluster spec"))
    return out


def _contiguity_findings(graph: OpGraph, schedule) -> List[Finding]:
    """Each stage's compute ops must be one contiguous chain() run, and the
    runs must appear in pipeline order covering the whole chain."""
    order = op_chain(graph)
    pos = {op: i for i, op in enumerate(order)}
    out: List[Finding] = []
    cursor = 0
    for d in schedule.stage_devices():
        idxs = sorted(pos[op] for op in schedule.assignment[d] if op in pos)
        if not idxs:
            continue
        lo, hi = idxs[0], idxs[-1]
        if idxs != list(range(lo, hi + 1)):
            gap = next(i for a, b in zip(idxs, idxs[1:])
                       for i in (a + 1,) if b != a + 1)
            out.append(Finding(
                "non-contiguous-stage", order[gap],
                f"CompNode {d} holds a chain gap: op {order[gap]!r} "
                f"(chain #{gap}) belongs to its [{order[lo]!r}..."
                f"{order[hi]!r}] run but lives elsewhere"))
            cursor = hi + 1
            continue
        if lo != cursor:
            out.append(Finding(
                "stage-order", order[lo],
                f"CompNode {d} starts at chain #{lo} ({order[lo]!r}) but "
                f"the pipeline cursor is at #{cursor} "
                f"({order[cursor]!r} misplaced)" if cursor < len(order)
                else f"CompNode {d} starts past the end of the chain"))
        cursor = max(cursor, hi + 1)
    return out


def _capacity_findings(graph: OpGraph, schedule,
                       profiles: Mapping[str, OpProfile],
                       cluster: ClusterSpec,
                       opt_state_mult: float,
                       mem_margin: float) -> List[Finding]:
    out: List[Finding] = []
    for d in schedule.stage_devices():
        if not 0 <= d < len(cluster):
            continue
        need = 0.0
        biggest, biggest_op = 0.0, ""
        for op in schedule.assignment[d]:
            p = profiles.get(op)
            if p is None:
                continue
            cost = p.param_bytes * (1.0 + opt_state_mult) + p.out_bytes
            need += cost
            if cost > biggest:
                biggest, biggest_op = cost, op
        cap = cluster.devices[d].mem_bytes * mem_margin
        if need > cap:
            out.append(Finding(
                "capacity", biggest_op or f"dev{d}",
                f"CompNode {d} ({cluster.devices[d].name}) needs "
                f"{need / 1e9:.2f} GB (params x(1+{opt_state_mult:g}) + "
                f"activations; largest op {biggest_op!r} at "
                f"{biggest / 1e9:.2f} GB) but holds {cap / 1e9:.2f} GB"))
    return out


def check_schedule(graph: OpGraph, schedule,
                   profiles: Optional[Mapping[str, OpProfile]] = None,
                   cluster: Optional[ClusterSpec] = None,
                   alive: Optional[Sequence[int]] = None,
                   opt_state_mult: float = 2.0,
                   mem_margin: float = 1.0,
                   check_capacity: bool = True) -> List[Finding]:
    findings = _coverage_findings(graph, schedule)
    findings += _stage_findings(graph, schedule, cluster, alive)
    if not any(f.code in ("double-assignment", "unknown-op")
               for f in findings):
        findings += _contiguity_findings(graph, schedule)
    if check_capacity and profiles is not None and cluster is not None \
            and len(schedule.assignment) == len(cluster):
        findings += _capacity_findings(graph, schedule, profiles, cluster,
                                       opt_state_mult, mem_margin)
    return findings


def verify_schedule(graph: OpGraph, schedule,
                    profiles: Optional[Mapping[str, OpProfile]] = None,
                    cluster: Optional[ClusterSpec] = None,
                    alive: Optional[Sequence[int]] = None,
                    opt_state_mult: float = 2.0,
                    mem_margin: float = 1.0,
                    check_capacity: bool = True,
                    strict: bool = False) -> List[Finding]:
    """Raise :class:`ScheduleCheckError` on any error-severity finding;
    returns the findings otherwise."""
    findings = check_schedule(graph, schedule, profiles=profiles,
                              cluster=cluster, alive=alive,
                              opt_state_mult=opt_state_mult,
                              mem_margin=mem_margin,
                              check_capacity=check_capacity)
    return raise_findings(findings, ScheduleCheckError,
                          "schedule failed verification", strict=strict)
