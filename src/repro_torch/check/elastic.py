"""Elastic re-plan checks (repro_torch.check, component 4).

A :class:`repro_torch.elastic.replan.ReplanResult` is only installable when

* the winning candidate is itself a valid schedule over the survivors
  (delegated to :func:`repro_torch.check.schedule.check_schedule` with
  ``alive=result.alive``),
* the migration move-set conserves parameter state **bit-for-bit in byte
  accounting**: every op that changed owner has exactly one move carrying
  ``state_bytes`` (params + optimizer state) from its true old owner —
  or from the checkpoint store (``src=None``) iff that owner is dead —
  and no move relocates an op that did not change owner,
* under ``pin_boundaries`` no node-to-node move crosses a bandwidth
  community (WAN) fence — the zero-cross-WAN guarantee the flag exists
  for,
* the candidate score table names exactly one winner and it is the mode
  the result claims.

:func:`verify_replan` raises :class:`ElasticCheckError` naming the
offending op/move.
"""
from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence

from repro_torch.core.estimator import ClusterSpec
from repro_torch.core.opgraph import OpGraph, OpProfile
from repro_torch.core.scheduler import Schedule
from repro_torch.elastic.replan import OpMove, ReplanResult, state_bytes

from .errors import ElasticCheckError, Finding, raise_findings
from .schedule import check_schedule


def check_moves(old: Schedule, new: Schedule,
                profiles: Mapping[str, OpProfile],
                moves: Sequence[OpMove],
                dead: Sequence[int] = (),
                opt_state_mult: float = 2.0) -> List[Finding]:
    """Byte-conservation audit: the move-set must be exactly the owner
    diff between ``old`` and ``new``, each move carrying the op's full
    parameter + optimizer state."""
    dead_set = {int(d) for d in dead}
    old_place, new_place = old.placement, new.placement
    by_op = {}
    out: List[Finding] = []
    for m in moves:
        if m.op in by_op:
            out.append(Finding("duplicate-move", m.op,
                               f"op {m.op!r} appears in two moves — state "
                               "would be double-counted"))
            continue
        by_op[m.op] = m
    for op, src in old_place.items():
        dst = new_place.get(op)
        moved = dst is not None and dst != src
        m = by_op.pop(op, None)
        if not moved:
            if m is not None:
                out.append(Finding(
                    "phantom-move", op,
                    f"op {op!r} did not change owner (stays on CompNode "
                    f"{src}) but the plan moves {m.nbytes} bytes "
                    f"{m.src}->{m.dst}"))
            continue
        if m is None:
            expect = state_bytes(profiles[op], opt_state_mult) \
                if op in profiles else 0
            out.append(Finding(
                "missing-move", op,
                f"op {op!r} changed owner {src}->{dst} but no move carries "
                f"its {expect} state bytes — parameters would be dropped"))
            continue
        want_src = None if src in dead_set else src
        if m.src != want_src:
            code = "dead-source-send" if want_src is None else "wrong-source"
            out.append(Finding(
                code, op,
                f"op {op!r} moves from {m.src!r} but its state lives "
                + ("in the checkpoint store (owner "
                   f"{src} is dead)" if want_src is None
                   else f"on CompNode {src}")))
        if m.dst != dst:
            out.append(Finding(
                "wrong-destination", op,
                f"op {op!r} is shipped to CompNode {m.dst} but the new "
                f"schedule places it on {dst}"))
        expect = state_bytes(profiles[op], opt_state_mult) \
            if op in profiles else 0
        if int(m.nbytes) != int(expect):
            out.append(Finding(
                "state-bytes-mismatch", op,
                f"op {op!r} move carries {m.nbytes} bytes but its state is "
                f"{expect} (n_params x 4 x (1+{opt_state_mult:g})) — "
                "migration would not conserve parameter state"))
    for op, m in by_op.items():
        out.append(Finding(
            "phantom-move", op,
            f"move for op {op!r} ({m.src}->{m.dst}, {m.nbytes} bytes) "
            "matches no op in the old placement"))
    return out


def check_pinned_moves(moves: Sequence[OpMove],
                       communities: Sequence[Sequence[int]]
                       ) -> List[Finding]:
    """Under ``pin_boundaries`` no node-to-node transfer may cross a
    bandwidth community; checkpoint streams (``src=None``) are exempt."""
    comm_of = {int(d): ci for ci, c in enumerate(communities) for d in c}
    out: List[Finding] = []
    for m in moves:
        if m.src is None:
            continue
        cs, cd = comm_of.get(int(m.src)), comm_of.get(int(m.dst))
        if cs is None or cd is None or cs != cd:
            out.append(Finding(
                "cross-cluster-migration", m.op,
                f"op {m.op!r} migrates {m.nbytes} bytes across the WAN "
                f"fence (CompNode {m.src} in community {cs} -> "
                f"{m.dst} in {cd}) — pin_boundaries forbids this"))
    return out


def _score_findings(result: ReplanResult) -> List[Finding]:
    out: List[Finding] = []
    if not result.scores:
        return out
    winners = [s.get("name") for s in result.scores if s.get("winner")]
    if winners != [result.mode]:
        out.append(Finding(
            "score-winner-mismatch", result.mode,
            f"result claims mode {result.mode!r} but the score table marks "
            f"{winners!r} as winner(s)"))
    for s in result.scores:
        for k in ("pace", "migration_bytes", "migration_seconds", "score"):
            v = s.get(k)
            if not isinstance(v, (int, float)) or math.isnan(v) or v < 0:
                out.append(Finding(
                    "bad-score", f"{s.get('name')}.{k}",
                    f"candidate {s.get('name')!r} has {k}={v!r}"))
    return out


def check_replan(graph: OpGraph, profiles: Mapping[str, OpProfile],
                 result: ReplanResult, old_schedule: Schedule,
                 cluster: Optional[ClusterSpec] = None,
                 opt_state_mult: float = 2.0,
                 pinned: bool = False,
                 communities: Optional[Sequence[Sequence[int]]] = None,
                 check_capacity: bool = False) -> List[Finding]:
    """Full audit of a :class:`ReplanResult` against the schedule it
    replaces: winner validity (op coverage over the survivors), move-set
    conservation, pinning, score-table consistency.

    ``check_capacity`` defaults off here: after heavy churn the survivors
    may *have* to over-subscribe memory to keep training at all — that is
    a planning-quality concern for the CLI sweep, not an installability
    invariant."""
    findings = check_schedule(graph, result.schedule, profiles=profiles,
                              cluster=cluster, alive=result.alive,
                              check_capacity=check_capacity)
    findings += check_moves(old_schedule, result.schedule, profiles,
                            result.migration.moves, dead=result.dead,
                            opt_state_mult=opt_state_mult)
    if pinned:
        comms = communities if communities is not None \
            else old_schedule.clusters or ()
        if comms:
            findings += check_pinned_moves(result.migration.moves, comms)
    findings += _score_findings(result)
    return findings


def verify_replan(graph: OpGraph, profiles: Mapping[str, OpProfile],
                  result: ReplanResult, old_schedule: Schedule,
                  cluster: Optional[ClusterSpec] = None,
                  opt_state_mult: float = 2.0,
                  pinned: bool = False,
                  communities: Optional[Sequence[Sequence[int]]] = None,
                  check_capacity: bool = False,
                  strict: bool = False) -> List[Finding]:
    findings = check_replan(graph, profiles, result, old_schedule,
                            cluster=cluster, opt_state_mult=opt_state_mult,
                            pinned=pinned, communities=communities,
                            check_capacity=check_capacity)
    return raise_findings(
        findings, ElasticCheckError,
        f"re-plan (mode {result.mode!r}) failed verification",
        strict=strict)
