"""Scripted churn scenarios for serving tests, CLI, and benchmark.

The interesting serving failure is the one that lands *mid-session*: a
stage replica dies while sessions whose chains cross it still have tokens
to emit, forcing the router to re-route and the runtime to replay KV onto
the replacement.  A failure time picked blindly usually misses — short
sessions drain between arrivals and the runtime's idle fast-forward jumps
the clock straight over the detection window, so nobody ever holds a dead
hop.

:func:`derive_midsession_failure` makes the scenario deterministic: run
the offered load once with no churn, read the first sufficiently long
multi-stage session's admit record off the flight log, and schedule the
death of its stage-1 replica at the midpoint of that session's own token
timeline.  The same requests replayed against the resulting
:class:`~repro_torch.elastic.membership.ChurnTrace` are then guaranteed (for a
detection lease much shorter than the remaining half of the session) to
hit a live session mid-decode.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.elastic.membership import (ChurnTrace, MembershipView,
                                            single_failure_trace)
from repro_torch.obs import FlightRecorder

from .plan import ServingPlan
from .reqtrace import Request
from .runtime import ServingReport, ServingRuntime


def derive_midsession_failure(
        cfg, params: Dict[str, Any], plan: ServingPlan,
        requests: Sequence[Request], n_devices: int,
        lease_s: float = 1e-5, min_tokens: int = 4, stage: int = 1,
        device: DeviceLike = "cuda",
) -> Tuple[int, float, ServingReport, Dict[str, List[int]]]:
    """Dry no-churn run; pick the failure that must interrupt a session.

    Returns ``(victim, at, baseline_report, baseline_tokens)``: the device
    serving stage ``stage`` of the first admitted session that spans at
    least ``min_tokens`` decode rounds, and the simulated time halfway
    through that session's token stream.  The baseline report/tokens come
    for free from the dry run — benchmarks use them as the no-churn leg.
    The dry run computes on ``device`` (the card unless told otherwise).
    """
    if stage >= plan.n_stages:
        raise ValueError(f"stage {stage} out of range for "
                         f"{plan.n_stages}-stage plan")
    view = MembershipView(n_devices, ChurnTrace(()), lease_s=lease_s)
    flight = FlightRecorder()
    tokens: Dict[str, List[int]] = {}
    times: Dict[str, List[float]] = {}

    def on_token(rid: str, tok: int, now: float) -> None:
        tokens.setdefault(rid, []).append(tok)
        times.setdefault(rid, []).append(now)

    runtime = ServingRuntime(cfg, params, plan, view, flight=flight,
                             on_token=on_token, device=device)
    report = runtime.run(list(requests))
    for rec in flight.records("route"):
        if rec.cause != "admit":
            continue
        ts = times.get(rec.session, [])
        if len(ts) >= min_tokens and len(rec.chain) > stage:
            victim = rec.chain[stage]
            at = (ts[0] + ts[-1]) / 2.0
            return victim, at, report, tokens

    raise ValueError(
        "no admitted session long enough to interrupt — lengthen "
        "generations or raise the arrival rate")


def churn_trace_for(victim: int, at: float) -> ChurnTrace:
    """The scripted trace killing ``victim`` at ``at`` simulated seconds."""
    return single_failure_trace(victim, at=at)
