"""The swarm serving runtime: continuous-batched stage-chained decode.

One :class:`ServingRuntime` closes the loop over the other serving modules:
real PyTorch compute through the stage executors (on ``device``, the card by
default), simulated-clock timing priced
by :class:`~repro_torch.serving.costs.ServingCostModel`, membership churn from the
elastic :class:`~repro_torch.elastic.membership.MembershipView`, routing decisions
from :class:`~repro_torch.serving.router.SessionRouter`, and observability through
the same span/metrics/flight-recorder spine training uses.

The loop is lockstep *rounds* on the simulated clock (the serving analogue
of the training simulator's discrete-event steps):

1. **poll membership** — newly detected leaves evict replicas; every active
   session with a dead hop is re-routed (survivor hops keep their KV) and
   the replacement's KV prefix is rebuilt by **replaying the session's
   recorded inputs through the same stage functions** — bit-exact, so
   churn never changes greedy output (pinned in tests);
2. **admit** — pop due requests while the router finds a chain with free
   slots on every stage (continuous batching: slots free per round, not per
   batch), run the real prefill along the chain, emit the first token;
3. **decode round** — every active session advances one token through its
   chain; per-device busy time, per-link batched transfer bytes and
   per-session token latency are accumulated from the cost model;
4. **advance** — the round takes as long as its bottleneck resource; spans
   land on ``dev<i>`` / ``link i->j`` tracks (the trace-order checker's
   serial-track invariants apply to serving timelines exactly as to
   training ones).

Timing semantics (simulated seconds — deliberately simple, documented so
the benchmark numbers are interpretable): per-token stage compute is
Eq. 1 ``C(f,p)`` at full-cache attention; a session's token latency is the
sum of its chain's compute + per-hop wire terms (plus any replay it waited
on this round); a round advances by the max over per-device busy and
per-link batched-transfer seconds.  The return hop (last stage back to the
client) and client links are not modeled.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.elastic.membership import MembershipView
from repro_torch.obs import (CAT_CONTROLLER, CAT_FWD, CAT_SERVE_PREFILL,
                       CAT_SERVE_REPLAY, CAT_TRANSFER, FlightRecorder,
                       Histogram, MetricsRegistry, TraceRecorder, Watchdog)

from .batching import RequestQueue
from .plan import ServingPlan
from .reqtrace import Request
from .router import NoChainError, SessionRouter
from .session import Session, StageState, summarize
from .stages import StageExecutor, stage_params

OnToken = Callable[[str, int, float], None]


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """Closed-loop run summary (the benchmark's per-scenario payload)."""

    n_sessions: int
    n_completed: int
    all_completed: bool
    n_reroutes: int
    tokens: int
    sim_seconds: float
    tokens_per_s: float
    p50_ms: float
    p99_ms: float
    rounds: int

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _percentiles(latencies: Sequence[float]) -> Tuple[float, float]:
    """p50/p99 in ms via the obs Histogram's bucketed percentile (base 1.01:
    within ~1% of the exact sample percentile) — one percentile
    implementation across serving and watchdogs, not a second hand-rolled
    np.percentile path."""
    if not latencies:
        return 0.0, 0.0
    h = Histogram(base=1.01)
    for lt in latencies:
        h.observe(float(lt))
    return h.percentile(50) * 1e3, h.percentile(99) * 1e3


class ServingRuntime:
    """Drives sessions over a :class:`ServingPlan` against scripted churn."""

    def __init__(self, cfg: ModelCfg, params: Dict[str, Any],
                 plan: ServingPlan, view: MembershipView,
                 trace: Optional[TraceRecorder] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 on_token: Optional[OnToken] = None,
                 watchdog: Optional[Watchdog] = None,
                 max_rounds: int = 100_000,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = plan
        self.view = view
        self.trace = trace
        self.metrics = metrics
        self.flight = flight
        self.on_token = on_token
        self.max_rounds = int(max_rounds)
        # streaming SLO/anomaly monitor: fed one aggregate tokens/s sample
        # per decode round (trips land in the shared flight recorder)
        self.watchdog = watchdog
        if watchdog is not None:
            if watchdog.flight is None:
                watchdog.flight = flight
            if watchdog.metrics is None:
                watchdog.metrics = metrics
        self.router = SessionRouter(plan, flight=flight, metrics=metrics)
        # one executor per stage, shared by all its replicas (identical
        # parameters => identical computation)
        self.executors: Dict[int, StageExecutor] = {
            spec.index: StageExecutor(cfg, spec,
                                      stage_params(cfg, params, spec),
                                      plan.cache_len, self.device)
            for spec in plan.stages}

    # ------------------------------------------------------------ helpers --
    def _greedy(self, logits) -> int:
        # the first maximum, as jnp.argmax
        return int(torch.argmax(logits[0, -1, :]))

    def _emit(self, sess: Session, tok: int, now: float) -> None:
        if self.metrics is not None:
            self.metrics.counter("serve.tokens").inc()
        if self.on_token is not None:
            self.on_token(sess.rid, tok, now)

    def _span(self, spans: List[Tuple], cat: str, name: str, track: str,
              t0: float, t1: float, rnd: int, **args) -> None:
        if self.trace is not None:
            spans.append((cat, name, track, t0, t1,
                          {"step": rnd, "epoch": self.view.epoch, **args}))

    def _flush_spans(self, spans: List[Tuple]) -> None:
        if self.trace is None:
            return
        for cat, name, track, t0, t1, args in sorted(
                spans, key=lambda s: (s[3], s[2], s[4])):
            self.trace.span(cat, name, track, t0, t1, args=args)

    # ------------------------------------------------------------- replay --
    def _replay_stage(self, sess: Session, stage: int) -> None:
        """Rebuild one stage's KV on its replacement replica by replaying
        the recorded inputs through the shared stage functions — the op and
        reduction order of the original computation, so the rebuilt cache
        is bit-identical."""
        st: StageState = sess.stages[stage]
        ex = self.executors[stage]
        _, kv = ex.prefill(st.prefill_input)
        plen = int(st.prefill_input.shape[1])
        for i, inp in enumerate(st.step_inputs):
            _, kv = ex.decode(inp, kv, plen + i)
        st.kv = kv

    def _replay_seconds(self, sess: Session, stage: int, new_dev: int) -> float:
        """Simulated cost of the replay: recompute every historical token on
        the replacement, plus shipping the recorded boundary inputs in from
        the upstream hop (stage 0 replays client-held token ids: no modeled
        wire)."""
        spec = self.plan.stages[stage]
        n = sess.replay_len(stage)
        secs = n * self.plan.costs.stage_seconds(new_dev, spec,
                                                 self.plan.cache_len)
        if stage > 0:
            prev = sess.chain[stage - 1]
            nbytes = n * self.plan.costs.stage_in_bytes_per_token(spec)
            secs += self.plan.costs.link_seconds(prev, new_dev, nbytes)
        return secs

    # ---------------------------------------------------------------- run --
    def run(self, requests: List[Request]) -> ServingReport:
        queue = RequestQueue(requests)
        active: List[Session] = []
        completed: List[Session] = []
        latencies: List[float] = []
        now = 0.0
        rnd = 0
        total_tokens = 0

        while active or not queue.empty:
            rnd += 1
            tokens_at_round_start = total_tokens
            if rnd > self.max_rounds:
                raise RuntimeError(
                    f"serving made no progress after {self.max_rounds} "
                    "rounds — a stage likely lost all replicas")
            # idle: fast-forward the sim clock to the next arrival
            if not active and not queue.due(now):
                nxt = queue.next_arrival()
                if nxt is not None:
                    now = max(now, nxt)
            self.view.poll(now)
            alive = set(self.view.alive)
            spans: List[Tuple] = []
            dev_cursor: Dict[int, float] = {}
            replay_penalty: Dict[str, float] = {}

            # -- 1. re-route sessions whose chain lost a replica ----------
            for sess in active:
                dead = sorted({d for d in sess.chain if d not in alive})
                if not dead:
                    continue
                old_chain = list(sess.chain)
                replaced = self.router.reroute(sess, dead, sorted(alive))
                replay_tokens = 0
                pen = 0.0
                for stage, new_dev in sorted(replaced.items()):
                    replay_tokens += sess.replay_len(stage)
                    secs = self._replay_seconds(sess, stage, new_dev)
                    pen += secs
                    t0 = dev_cursor.get(new_dev, now)
                    self._span(spans, CAT_SERVE_REPLAY,
                               f"replay.{sess.rid}.s{stage}",
                               f"dev{new_dev}", t0, t0 + secs, rnd,
                               session=sess.rid,
                               tokens=sess.replay_len(stage))
                    dev_cursor[new_dev] = t0 + secs
                    self._replay_stage(sess, stage)
                replay_penalty[sess.rid] = pen
                self.router.log_route(sess, "reroute", old_chain, dead,
                                      replay_tokens, now, rnd)
                if self.trace is not None:
                    self.trace.instant(
                        CAT_CONTROLLER, f"reroute.{sess.rid}", "controller",
                        t=now, args={"dead": dead, "chain": list(sess.chain),
                                     "replay_tokens": replay_tokens})

            # -- 2. continuous-batching admission -------------------------
            admitted_now: List[Session] = []
            while queue.due(now) and self.router.has_capacity(sorted(alive)):
                req = queue.pop(now)
                chain = self.router.pick_chain(sorted(alive))
                self.router.acquire(chain)
                sess = Session(request=req, chain=list(chain),
                               admitted_at=now)
                lat = 0.0
                x = torch.tensor(req.prompt, dtype=torch.int32,
                                 device=self.device)[None, :]
                for stage, dev in enumerate(chain):
                    spec = self.plan.stages[stage]
                    out, kv = self.executors[stage].prefill(x)
                    sess.stages[stage].record_prefill(x, kv)
                    S = len(req.prompt)
                    secs = S * self.plan.costs.stage_seconds(
                        dev, spec, self.plan.cache_len)
                    if stage > 0:
                        secs += self.plan.costs.link_seconds(
                            chain[stage - 1], dev,
                            S * self.plan.costs.stage_in_bytes_per_token(spec))
                    t0 = dev_cursor.get(dev, now)
                    self._span(spans, CAT_SERVE_PREFILL,
                               f"prefill.{req.rid}.s{stage}", f"dev{dev}",
                               t0, t0 + secs, rnd, session=req.rid, S=S)
                    dev_cursor[dev] = t0 + secs
                    lat += secs
                    x = out
                sess.pos = len(req.prompt)
                tok = self._greedy(x)
                sess.generated.append(tok)
                sess.token_latencies.append(lat)
                latencies.append(lat)
                total_tokens += 1
                self._emit(sess, tok, now)
                if self.metrics is not None:
                    self.metrics.counter("serve.requests",
                                         event="admitted").inc()
                self.router.log_route(sess, "admit", list(chain), [], 0,
                                      now, rnd)
                active.append(sess)
                admitted_now.append(sess)

            # -- 3. lockstep decode round ---------------------------------
            dev_busy: Dict[int, float] = {}
            link_bytes: Dict[Tuple[int, int], float] = {}
            for sess in active:
                if sess in admitted_now or sess.done:
                    continue   # prefill already produced this round's token
                lat = replay_penalty.pop(sess.rid, 0.0)
                x = torch.tensor([[sess.generated[-1]]], dtype=torch.int32,
                                 device=self.device)
                for stage, dev in enumerate(sess.chain):
                    spec = self.plan.stages[stage]
                    st = sess.stages[stage]
                    out, kv = self.executors[stage].decode(
                        x, st.kv, sess.pos)
                    st.record_step(x, kv)
                    secs = self.plan.costs.stage_seconds(
                        dev, spec, self.plan.cache_len)
                    dev_busy[dev] = dev_busy.get(dev, 0.0) + secs
                    lat += secs
                    if stage > 0:
                        link = (sess.chain[stage - 1], dev)
                        if link[0] != link[1]:
                            nb = self.plan.costs.stage_in_bytes_per_token(spec)
                            link_bytes[link] = link_bytes.get(link, 0.0) + nb
                            lat += self.plan.costs.link_seconds(*link, nb)
                    x = out
                tok = self._greedy(x)
                sess.generated.append(tok)
                sess.pos += 1
                sess.token_latencies.append(lat)
                latencies.append(lat)
                total_tokens += 1
                self._emit(sess, tok, now)

            # -- 4. advance the clock by the bottleneck resource ----------
            round_end = now
            for dev, busy in sorted(dev_busy.items()):
                t0 = dev_cursor.get(dev, now)
                self._span(spans, CAT_FWD, f"decode.r{rnd}", f"dev{dev}",
                           t0, t0 + busy, rnd,
                           sessions=sum(1 for s in active
                                        if dev in s.chain))
                dev_cursor[dev] = t0 + busy
            for (i, j), nb in sorted(link_bytes.items()):
                secs = self.plan.costs.link_seconds(i, j, nb)
                self._span(spans, CAT_TRANSFER, f"hop.r{rnd}",
                           f"link {i}->{j}", now, now + secs, rnd,
                           bytes=nb)
                round_end = max(round_end, now + secs)
            for dev, t in dev_cursor.items():
                round_end = max(round_end, t)
            self._flush_spans(spans)

            # -- 5. retire finished sessions ------------------------------
            still: List[Session] = []
            for sess in active:
                if sess.done:
                    sess.finished_at = round_end
                    self.router.release(sess.chain)
                    completed.append(sess)
                    if self.metrics is not None:
                        self.metrics.counter("serve.requests",
                                             event="completed").inc()
                else:
                    still.append(sess)
            active = still
            prev_now = now
            now = round_end if round_end > now else now + 1e-9
            if self.watchdog is not None:
                made = total_tokens - tokens_at_round_start
                dt = now - prev_now
                if made > 0 and dt > 0.0:
                    self.watchdog.observe_tokens(rnd, now, made / dt)

        if self.metrics is not None:
            h = self.metrics.histogram("serve.token_latency_ms")
            for lt in latencies:
                h.observe(lt * 1e3)
        stats = summarize(completed)
        p50, p99 = _percentiles(latencies)
        return ServingReport(
            n_sessions=stats["n_sessions"],
            n_completed=stats["n_completed"],
            all_completed=stats["all_completed"] and queue.empty,
            n_reroutes=stats["n_reroutes"],
            tokens=total_tokens,
            sim_seconds=now,
            tokens_per_s=total_tokens / now if now > 0 else 0.0,
            p50_ms=p50, p99_ms=p99, rounds=rnd)


__all__ = ["NoChainError", "OnToken", "ServingReport", "ServingRuntime"]
