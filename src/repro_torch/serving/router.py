"""Session router: pick a live chain of stage replicas, re-route on death.

The Petals client routes every session through one server per block range
and swaps a dead server out mid-generation (``RemoteSequential`` +
``InferenceSession``, SNIPPETS.md 1–2).  :class:`SessionRouter` is that
logic against our :class:`~repro_torch.serving.plan.ServingPlan`:

* **admission routing** — greedy front-to-back over the stages, scoring
  each alive replica by ``stage_seconds × (1 + active sessions)`` (a
  load-scaled Eq. 1 compute term) plus the inbound hop priced by the
  calibrated cost model.  Load-scaling keeps the fastest replica from
  absorbing every session while its siblings idle.
* **mid-session re-routing** — when the membership view detects a dead
  replica, only the dead hops are replaced (survivors keep their KV; no
  gratuitous replays).  The replacement's KV prefix is rebuilt by the
  runtime via input replay; the router prices that replay (and what the
  alternative KV shipment would have cost) and logs both in the decision.

Every decision lands in the :class:`~repro_torch.obs.record.FlightRecorder` as a
:class:`~repro_torch.obs.record.RouteRecord`, so a serving run's flight log
explains each session's path the way training logs explain re-plans.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.obs import FlightRecorder, MetricsRegistry, RouteRecord

from .plan import ServingPlan
from .session import Session


class NoChainError(RuntimeError):
    """Some stage has no alive replica — the swarm cannot serve."""


class SessionRouter:
    """Routes sessions over a plan's replica sets, tracking per-replica load."""

    def __init__(self, plan: ServingPlan,
                 flight: Optional[FlightRecorder] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.plan = plan
        self.flight = flight
        self.metrics = metrics
        self.load: Dict[int, int] = {d: 0 for d in plan.devices()}

    # ---------------------------------------------------------- capacity --
    def alive_replicas(self, stage: int, alive: Sequence[int]) -> List[int]:
        live = set(alive)
        return [d for d in self.plan.replicas[stage] if d in live]

    def has_capacity(self, alive: Sequence[int]) -> bool:
        """Can one more session be admitted right now?  True iff every stage
        has an alive replica with a free slot (admit-on-slot-free)."""
        for spec in self.plan.stages:
            if not any(self.load[d] < self.plan.max_batch
                       for d in self.alive_replicas(spec.index, alive)):
                return False
        return True

    # ----------------------------------------------------------- scoring --
    def _score(self, device: int, stage: int, prev: Optional[int]) -> float:
        spec = self.plan.stages[stage]
        compute = self.plan.costs.stage_seconds(device, spec,
                                                self.plan.cache_len)
        hop = 0.0 if prev is None \
            else self.plan.costs.hop_seconds(prev, device, spec)
        return compute * (1 + self.load[device]) + hop

    def _pick_stage(self, stage: int, prev: Optional[int],
                    alive: Sequence[int], require_slot: bool = True) -> int:
        cands = self.alive_replicas(stage, alive)
        if require_slot:
            cands = [d for d in cands if self.load[d] < self.plan.max_batch]
        if not cands:
            raise NoChainError(
                f"stage {stage} has no alive replica with a free slot "
                f"(replicas={self.plan.replicas[stage]}, alive={list(alive)})")
        return min(cands, key=lambda d: (self._score(d, stage, prev), d))

    # ---------------------------------------------------------- admission --
    def pick_chain(self, alive: Sequence[int]) -> List[int]:
        """Greedy front-to-back chain, one alive replica per stage."""
        chain: List[int] = []
        prev: Optional[int] = None
        for spec in self.plan.stages:
            dev = self._pick_stage(spec.index, prev, alive)
            chain.append(dev)
            prev = dev
        return chain

    def acquire(self, chain: Sequence[int]) -> None:
        for d in chain:
            self.load[d] += 1

    def release(self, chain: Sequence[int]) -> None:
        for d in chain:
            self.load[d] = max(0, self.load[d] - 1)

    def log_route(self, session: Session, cause: str, old_chain: List[int],
                  dead: List[int], replay_tokens: int,
                  now: float, step: int) -> None:
        if self.metrics is not None:
            self.metrics.counter("serve.routes", cause=cause).inc()
        if self.flight is None:
            return
        kv_ship = sum(
            self.plan.costs.kv_bytes_per_token(self.plan.stages[s])
            * session.pos
            for s, (o, n) in enumerate(zip(old_chain, session.chain))
            if o != n) if cause == "reroute" else 0
        self.flight.log(RouteRecord(
            step=step, clock=now, session=session.rid, cause=cause,
            dead=list(dead), old_chain=list(old_chain),
            chain=list(session.chain), replay_tokens=int(replay_tokens),
            kv_ship_bytes=int(kv_ship)))

    # ---------------------------------------------------------- rerouting --
    def reroute(self, session: Session, dead: Sequence[int],
                alive: Sequence[int]) -> Dict[int, int]:
        """Replace dead hops in ``session.chain``; survivors keep their KV.

        Returns ``{stage: new_device}`` for the replaced hops (the runtime
        replays the session's input history onto each).  Replacements are
        admitted even at full ``max_batch`` (an evicted replica's sessions
        outrank new admissions; the queue absorbs the pressure).
        """
        dead_set = set(dead)
        replaced: Dict[int, int] = {}
        prev: Optional[int] = None
        for spec in self.plan.stages:
            s = spec.index
            cur = session.chain[s]
            if cur in dead_set:
                new = self._pick_stage(s, prev, alive, require_slot=False)
                self.load[new] += 1          # dead device's slot moves over
                if cur in self.load:
                    self.load[cur] = max(0, self.load[cur] - 1)
                session.chain[s] = new
                replaced[s] = new
            prev = session.chain[s]
        if replaced:
            session.n_reroutes += 1
        return replaced
