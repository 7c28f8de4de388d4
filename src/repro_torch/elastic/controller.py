"""ElasticController: drives the FusionLLM runtime across membership epochs.

One epoch = one stable OP-Fence schedule.  Per training step the controller
(1) runs the real RAD numerics through :class:`DecentralizedRuntime` (unless
``train=False``), (2) advances a simulated wall-clock by the discrete-event
:func:`simulate_iteration` on the *ground-truth* cluster (scripted slowdowns
applied), (3) feeds the executor's telemetry samples through the broker's
:class:`TelemetryLog` and hands the aggregated per-CompNode step times to
the straggler detector — ``predict_step_times`` supplies only the detector's
reference *prediction*, never the observation — and (4) polls the
lease-based membership view.  On a detected failure, join, straggler, or
recovery it transitions epochs: re-plan via OP-Fence on the survivors,
migrate state bit-exactly through the checkpoint wire format, and charge the
simulated clock for what churn really costs:

    detection delay   — implicit: the clock kept running (wasted) between the
                        failure and its lease expiry / telemetry warm-up;
    lost work         — steps after the last checkpoint that predates the
                        failure are rolled back (their samples don't count);
    migration         — bulk state transfers over the real α–β links
                        (:func:`simulate_migration`);
    pipeline refill   — a fresh schedule starts cold (fill term of Eq. 3).

Two migration modes:

* ``migration_mode="stop"`` — training halts while the
  whole migration plan streams, then the new schedule starts cold.
* ``migration_mode="overlap"`` — training *continues* while survivor-to-
  survivor state streams in the background over bandwidth-shared links
  (:func:`repro_torch.core.network.with_shared_links` slows the foreground
  boundary traffic on the specific wires the stream rides, it does not block
  it; ``overlap_bandwidth_share`` is the fraction the *foreground* keeps on
  a contended link — default 0.75, training has priority and the stream
  scavenges the rest).  After a failure, only the dead
  CompNodes' shards block: they stream from the checkpoint store into an
  *interim* schedule (:func:`repro_torch.elastic.replan.interim_schedule` — the
  old schedule with each dead segment merged into an adjacent surviving
  stage), training resumes on it, and the cut-over to the final re-planned
  schedule charges only the residual transfer (a hot hand-off between warm
  schedules — no second cold fill).  A broker-side cost model streams only
  when the target's pace pays for the foreground slowdown within
  ``amortize_steps``; otherwise the interim schedule simply becomes the
  epoch's schedule (fair-share conservation: bytes crossing the pipeline's
  own bottleneck wire cannot be hidden by overlapping).

Closed planning loop (beyond a passive cost model): the controller
periodically re-fits per-link corrections from the telemetry window's
MAD-filtered per-link transfer observations
(:meth:`repro_torch.elastic.telemetry.TelemetryLog.link_samples` →
:func:`repro_torch.core.costmodel.fit_link_corrections`, always against the
*uncorrected* base spec so re-fits replace rather than compound) and installs
the calibrated :class:`EdgeCostModel` everywhere the broker prices anything:
the detector's reference prediction (repriced in place, EWMA history kept),
the re-planner's candidate costs, the joint co-planner, and the
stream-vs-keep broker.  The same loop fits per-device codec costs
(:meth:`TelemetryLog.kernel_samples` →
:func:`repro_torch.core.costmodel.fit_kernel_costs`) so the planner's
``compress_seconds`` term prices encode time from measured ``KernelTiming``
samples, not assumptions.  Hysteresis (``calibrate_hysteresis``) keeps a
single noisy window from thrashing; when the calibrated pace of the *active* plan
drifts more than ``replan_pace_margin`` past the pace it was installed at, a
``"calibration"`` epoch re-plans on the corrected costs (a re-plan that
returns the same assignment is a no-op — no migration, no refill).

``planner="joint"`` puts :func:`repro_torch.core.scheduler.schedule_joint` in
charge of epoch plans end to end — initial schedule, full re-plan candidate,
and (by default) an AdaTopK plan factory at ``joint_ratio`` — so OP-Fence ×
AdaTopK co-planning is what actually runs during training.  The planning
loop is closed end to end, and ``pin_boundaries`` defaults to True in
overlap mode for EVERY planner (a background stream cannot hide
cross-WAN bytes, so no overlap-mode re-cut should create any — the
rationale is the stream's, not the joint planner's); pass
``pin_boundaries=False`` to restore the unpinned overlap behaviour.

``device`` (default ``"cuda"``; a missing card raises) is where each
epoch's :class:`DecentralizedRuntime` runs the numerics; the parameters
passed to :meth:`ElasticController.run` are the caller's, already there.
Checkpoints, rollbacks and migrations restore every leaf onto the device
it came from.

Determinism contract: same graph/cluster/trace/seeds → identical epochs,
schedules, clocks, and (when training) identical losses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import deserialize_state, serialize_state
from repro_torch.core.compression import CompressionPlan, plan_adatopk, plan_none
from repro_torch.core.costmodel import (EdgeCostModel, KernelCostModel,
                                  fit_kernel_costs, fit_link_corrections)
from repro_torch.core.estimator import ClusterSpec, predict_step_times
from repro_torch.core.executor import (DecentralizedRuntime, TelemetrySink,
                                 pipeline_fill_seconds, simulate_iteration,
                                 simulate_migration)
from repro_torch.core.network import (with_link_slowdowns, with_shared_links,
                                with_slowdowns)
from repro_torch.core.opgraph import OpGraph, OpProfile
from repro_torch.core.scheduler import Schedule, schedule_joint, schedule_opfence
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import (CalibrationRecord, CandidateScore, DetectorRecord,
                       EpochFlightRecord, FlightRecorder, MetricsRegistry,
                       MetricsTelemetrySink, ReplanRecord, TelemetryBus,
                       TraceRecorder)
from repro_torch.obs.record import links_to_str
from repro_torch.obs.trace import CAT_CHECKPOINT, CAT_CONTROLLER, CAT_MIGRATION
from repro_torch.optim.optimizers import Optimizer

from .detector import StragglerDetector
from .membership import ChurnEvent, ChurnTrace, MembershipView
from .migrate import apply_moves, assert_bitexact
from .replan import (MigrationPlan, OpMove, ReplanResult, _group_transfers,
                     diff_schedules, interim_schedule, replan)
from .telemetry import TelemetryLog

PlanFactory = Callable[[OpGraph, Mapping[str, OpProfile], ClusterSpec,
                        Mapping[str, int]], CompressionPlan]


@dataclasses.dataclass
class StepRecord:
    step: int                  # data step index (replays after a rollback)
    epoch: int
    loss: Optional[float]
    step_seconds: float        # simulated iteration wall-clock
    clock: float               # cumulative simulated time at step end
    lost: bool = False         # rolled back by a later failure
    overlapping: bool = False  # executed while a background migration ran


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    at_step: int               # first data step executed under this epoch
    clock: float               # sim time when the epoch began
    cause: str                 # initial | failure | join | straggler |
                               # recovery | cutover | calibration
    events: List[ChurnEvent]
    alive: List[int]
    stage_devices: List[int]
    n_moves: int
    moved_bytes: float
    detect_seconds: float      # event time -> broker noticing
    migrate_seconds: float     # blocking (foreground) migration wall-clock
    refill_seconds: float
    rollback_steps: int
    replan_mode: str = ""      # full | anchored | interim
    background_bytes: float = 0.0   # streamed while training continued
    overlap_seconds: float = 0.0    # trained wall-clock during the stream


@dataclasses.dataclass
class ElasticRunResult:
    steps: List[StepRecord]
    epochs: List[EpochRecord]
    params: Any
    opt_state: Any
    total_seconds: float

    @property
    def losses(self) -> List[Tuple[int, float]]:
        """(data step, loss) for surviving (non-rolled-back) steps."""
        return [(r.step, r.loss) for r in self.steps
                if not r.lost and r.loss is not None]

    @property
    def useful_steps(self) -> int:
        return sum(1 for r in self.steps if not r.lost)

    def samples_per_second(self, batch_size: int) -> float:
        if self.total_seconds <= 0:
            return float("inf")
        return self.useful_steps * batch_size / self.total_seconds

    def post_failure_throughput(self, batch_size: int) -> float:
        """Useful samples per second in the window after the first failure
        epoch began — the recovery-path metric overlapped migration targets.
        inf when no failure occurred."""
        fails = [e for e in self.epochs if e.cause == "failure"]
        if not fails:
            return float("inf")
        t0 = fails[0].clock - fails[0].migrate_seconds \
            - fails[0].refill_seconds
        useful = sum(1 for r in self.steps
                     if not r.lost and r.clock > t0)
        window = self.total_seconds - t0
        return useful * batch_size / window if window > 0 else float("inf")


@dataclasses.dataclass
class _Checkpoint:
    step: int                  # state AFTER this many data steps
    clock: float               # sim time when taken
    blob: Optional[bytes]      # None in sim-only mode


@dataclasses.dataclass
class _OverlapState:
    """Background migration in flight: the target schedule and its bulk
    transfers, draining while foreground training continues."""

    target: Schedule
    replan_mode: str
    moves: List[OpMove]
    bg_seconds: float          # total stream time at shared bandwidth
    busy: Tuple[Tuple[int, int], ...]   # links the stream contends on
    progressed: float = 0.0


class ElasticController:
    """Churn-tolerant training controller (see module docstring)."""

    def __init__(self, graph: OpGraph, profiles: Mapping[str, OpProfile],
                 cluster: ClusterSpec, trace: ChurnTrace,
                 optimizer: Optional[Optimizer] = None,
                 plan_factory: Optional[PlanFactory] = None,
                 n_micro: int = 2, seed: int = 0,
                 lease_s: float = 10.0,
                 checkpoint_interval: int = 1,
                 checkpoint_history: int = 8,
                 detector_alpha: float = 0.4,
                 detector_threshold: float = 1.8,
                 detector_min_obs: int = 3,
                 telemetry_window: int = 5,
                 telemetry_mad_k: float = 3.5,
                 opt_state_mult: float = 2.0,
                 replan_mode: str = "auto",
                 amortize_steps: float = 100.0,
                 migration_mode: str = "stop",
                 overlap_bandwidth_share: float = 0.75,
                 pin_boundaries: Optional[bool] = None,
                 planner: str = "opfence",
                 joint_ratio: float = 100.0,
                 calibrate_interval: int = 5,
                 calibrate_min_samples: int = 3,
                 calibrate_hysteresis: float = 0.2,
                 replan_pace_margin: float = 0.25,
                 use_kernel: bool = False,
                 kernel_costs: Optional[Mapping[int, KernelCostModel]] = None,
                 initial_alive: Optional[Sequence[int]] = None,
                 tracer: Optional[TraceRecorder] = None,
                 flight: Optional[FlightRecorder] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 watchdog: Optional[Any] = None,
                 verify: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if migration_mode not in ("stop", "overlap"):
            raise ValueError(f"unknown migration_mode {migration_mode!r}")
        if planner not in ("opfence", "joint"):
            raise ValueError(f"unknown planner {planner!r}")
        self.graph = graph
        self.profiles = profiles
        self.base_cluster = cluster
        self.optimizer = optimizer
        self.planner = planner
        self.joint_ratio = float(joint_ratio)
        if plan_factory is not None:
            self.plan_factory = plan_factory
        elif planner == "joint":
            # the joint co-planner's converged plan for a placement is
            # exactly plan_adatopk at the same ratio under the same base
            # model, so anchored/interim schedules get co-consistent plans
            self.plan_factory = self._joint_plan_factory
        else:
            self.plan_factory = \
                lambda g, prof, cl, placement: plan_none(g, placement)
        self.n_micro = int(n_micro)
        self.seed = int(seed)
        self.checkpoint_interval = max(1, int(checkpoint_interval))
        self.checkpoint_history = max(2, int(checkpoint_history))
        self.opt_state_mult = float(opt_state_mult)
        self.replan_mode = replan_mode
        self.amortize_steps = float(amortize_steps)
        self.migration_mode = migration_mode
        self.overlap_bandwidth_share = float(overlap_bandwidth_share)
        # with the joint planner driving epoch plans end-to-end, overlap mode
        # defaults to boundary pinning: the background stream cannot hide
        # cross-WAN traffic, so the re-cut must not create any
        self.pin_boundaries = (migration_mode == "overlap") \
            if pin_boundaries is None else bool(pin_boundaries)
        self.calibrate_interval = max(0, int(calibrate_interval))
        self.calibrate_min_samples = max(1, int(calibrate_min_samples))
        self.calibrate_hysteresis = float(calibrate_hysteresis)
        self.replan_pace_margin = float(replan_pace_margin)
        self.use_kernel = use_kernel
        # ground-truth per-device codec costs for the simulator (what encode
        # actually costs on each host); the broker's *belief* starts empty
        # and is fitted from KernelTiming telemetry by _calibrate — the same
        # truth-vs-belief split as compute slowdowns and link corrections
        self.kernel_costs: Dict[int, KernelCostModel] = dict(kernel_costs or {})
        self.kernel_cost_belief: Dict[int, KernelCostModel] = {}
        # static verification (repro_torch.check) of every plan this controller
        # installs: schedules at install time, re-plans inside replan(),
        # compression plans against the installed placement.  verify=False
        # opts the whole runtime out (perf sweeps).
        self.verify = bool(verify)
        self._det_cfg = dict(alpha=detector_alpha,
                             threshold=detector_threshold,
                             min_observations=detector_min_obs)
        self.telemetry = TelemetryLog(window=telemetry_window,
                                      mad_k=telemetry_mad_k)
        # Observability (all optional, all no-ops when absent): the tracer
        # records sim-clock spans (named ``tracer`` — the 4th positional arg
        # ``trace`` is the churn script), the flight recorder logs every
        # broker decision, and the metrics registry aggregates counters.
        # Telemetry flows through a bus so the broker's TelemetryLog and the
        # metrics sink observe the exact same sample stream (parity tested).
        self.tracer = tracer
        self.flight = flight
        self.metrics = metrics
        self.telemetry_bus = TelemetryBus([self.telemetry])
        if metrics is not None:
            self.telemetry_bus.subscribe(MetricsTelemetrySink(metrics))
        # The watchdog is the *knowing* half of the control loop: it flags a
        # regime shift on the first degraded sample (flight record + slog
        # warning), steps before this controller's own windowed detector has
        # enough evidence to *act* — asserted in the churn acceptance test.
        self.watchdog = watchdog
        if watchdog is not None:
            if watchdog.flight is None:
                watchdog.flight = flight
            if watchdog.metrics is None:
                watchdog.metrics = metrics
            self.telemetry_bus.subscribe(watchdog)

        self.membership = MembershipView(len(cluster), trace, lease_s=lease_s,
                                         initial_alive=initial_alive)
        self.believed_factors: Dict[int, float] = {}
        self.link_corrections: Dict[Tuple[int, int], float] = {}
        self.calibration_count = 0       # hysteresis-passing fits installed
        self._steps_since_fit = 0
        self._installed_pace = 0.0       # believed pace of the active plan
        self.epoch_records: List[EpochRecord] = []
        self.step_records: List[StepRecord] = []
        self.clock = 0.0
        self._migrating: Optional[_OverlapState] = None
        self._deferred_deltas: List[Any] = []   # ripened during a stream
        self._install_schedule(cause="initial", events=[], dead=[],
                               at_step=0, detect_seconds=0.0,
                               migration=None, rollback_steps=0,
                               charge_refill=False)

    # ----------------------------------------------------------- topology --
    def believed_cluster(self) -> ClusterSpec:
        """What the broker schedules against: base sheets degraded by the
        detector's confirmed slowdowns.  Link-level belief lives in
        ``link_corrections`` (carried by :meth:`believed_model`), not here —
        the α–β sheets stay pristine so calibration always fits against the
        uncorrected spec."""
        return with_slowdowns(self.base_cluster, self.believed_factors)

    def believed_model(self, believed: Optional[ClusterSpec] = None,
                       plan: Optional[CompressionPlan] = None
                       ) -> EdgeCostModel:
        """The broker's full cost belief: believed compute sheets × the
        epoch's compression plan × telemetry-calibrated link corrections.
        Every planning-side consumer (detector reference prediction,
        re-planner, joint co-planner, pace checks) reads this one model."""
        return EdgeCostModel(self.graph, self.profiles,
                             believed if believed is not None
                             else self.believed_cluster(),
                             plan if plan is not None else self.plan,
                             self.link_corrections,
                             self.kernel_cost_belief)

    def true_cluster(self) -> ClusterSpec:
        """Ground truth for the simulator: scripted compute and link
        degradations in force now."""
        return with_link_slowdowns(
            with_slowdowns(self.base_cluster, self.membership.slow_factor),
            self.membership.link_factor)

    def _joint_plan_factory(self, graph: OpGraph,
                            profiles: Mapping[str, OpProfile],
                            cluster: ClusterSpec,
                            placement: Mapping[str, int]) -> CompressionPlan:
        """Default plan factory under ``planner='joint'``: AdaTopK at the
        co-planner's ratio, priced by the corrections-bearing model."""
        return plan_adatopk(graph, profiles, cluster, placement,
                            self.joint_ratio,
                            cost_model=EdgeCostModel(
                                graph, profiles, cluster, None,
                                self.link_corrections,
                                self.kernel_cost_belief))

    # ----------------------------------------------------------- epochs ----
    def _install_schedule(self, cause: str, events: List[ChurnEvent],
                          dead: Sequence[int], at_step: int,
                          detect_seconds: float,
                          migration: Optional[MigrationPlan],
                          rollback_steps: int,
                          replan_mode: str = "",
                          schedule: Optional[Schedule] = None,
                          migrate_seconds: Optional[float] = None,
                          charge_refill: bool = True,
                          background_bytes: float = 0.0,
                          overlap_seconds: float = 0.0) -> None:
        believed = self.believed_cluster()
        if schedule is not None:
            self.schedule = schedule
            if self.verify:
                # re-plans were verified inside replan(); this catches the
                # other installers (interim schedules, caller-built ones)
                from repro_torch.check.schedule import verify_schedule
                verify_schedule(self.graph, self.schedule,
                                profiles=self.profiles, cluster=believed,
                                check_capacity=False)
        elif migration is None:   # initial epoch: schedule from scratch
            if self.planner == "joint":
                self.schedule = schedule_joint(
                    self.graph, self.profiles, believed,
                    ratio=self.joint_ratio, seed=self.seed,
                    device_subset=self.membership.alive,
                    cost_model=EdgeCostModel(
                        self.graph, self.profiles, believed, None,
                        self.link_corrections, self.kernel_cost_belief),
                    verify=self.verify).schedule
            else:
                self.schedule = schedule_opfence(
                    self.graph, self.profiles, believed, seed=self.seed,
                    device_subset=self.membership.alive,
                    verify=self.verify)
        placement = self.schedule.placement
        self.plan = self.plan_factory(self.graph, self.profiles, believed,
                                      placement)
        if self.verify:
            from repro_torch.check.costs import verify_plan
            verify_plan(self.graph, self.profiles, self.plan,
                        placement=placement,
                        cost_model=self.believed_model(believed, self.plan))
        migrate_s = migration.seconds if migration is not None else 0.0
        if migrate_seconds is not None:   # caller-computed blocking cost
            migrate_s = migrate_seconds
        n_moves = len(migration.moves) if migration is not None else 0
        moved_bytes = migration.total_bytes if migration is not None else 0.0
        refill_s = pipeline_fill_seconds(
            self.graph, self.profiles, self.schedule,
            self.true_cluster(), self.plan) if charge_refill else 0.0
        clock_before = self.clock
        self.clock += migrate_s + refill_s
        self._obs_cache = None
        self.telemetry.clear()   # a new schedule invalidates old samples
        self.runtime = DecentralizedRuntime(self.graph, self.schedule,
                                            self.plan,
                                            use_kernel=self.use_kernel,
                                            trace=self.tracer,
                                            device=self.device)
        # the detector's reference prediction must share the epoch's
        # compression plan AND the calibrated link corrections with the
        # telemetry it is compared against — a dense or spec-priced reference
        # over-predicts/under-predicts comm and lets a genuinely slowed node
        # hide below threshold (or flags a healthy one on a slow-but-known
        # link)
        model = self.believed_model(believed)
        self.detector = StragglerDetector(
            predict_step_times(self.graph, self.profiles, believed,
                               placement, cost_model=model),
            **self._det_cfg)
        # the pace this plan was installed at, under the broker's current
        # belief — the reference the calibration re-plan trigger diverges from
        self._installed_pace = model.stage_pace(self.schedule)
        self._steps_since_fit = 0
        self.epoch_records.append(EpochRecord(
            epoch=len(self.epoch_records), at_step=at_step, clock=self.clock,
            cause=cause, events=list(events),
            alive=list(self.membership.alive),
            stage_devices=self.schedule.stage_devices(),
            n_moves=n_moves, moved_bytes=moved_bytes,
            detect_seconds=detect_seconds, migrate_seconds=migrate_s,
            refill_seconds=refill_s, rollback_steps=rollback_steps,
            replan_mode=replan_mode, background_bytes=background_bytes,
            overlap_seconds=overlap_seconds))
        self._observe_epoch(self.epoch_records[-1], migration, model,
                            clock_before)

    def _observe_epoch(self, rec: EpochRecord,
                       migration: Optional[MigrationPlan],
                       model: EdgeCostModel, clock_before: float) -> None:
        """Fold one installed epoch into the observability layer: a flight
        record, the per-cause metrics, and sim-clock spans for the blocking
        migration's bulk transfers (shifted from the migration simulator's
        local origin to where the stall actually sat on the run clock)."""
        if self.flight is not None:
            self.flight.log(EpochFlightRecord(
                step=rec.at_step, clock=self.clock, epoch=rec.epoch,
                cause=rec.cause, stage_devices=list(rec.stage_devices),
                n_moves=rec.n_moves, moved_bytes=rec.moved_bytes,
                migrate_seconds=rec.migrate_seconds,
                refill_seconds=rec.refill_seconds,
                rollback_steps=rec.rollback_steps,
                replan_mode=rec.replan_mode))
        if self.metrics is not None:
            self.metrics.counter("replan_count", cause=rec.cause).inc()
            if rec.rollback_steps:
                self.metrics.counter("rollback_steps").inc(rec.rollback_steps)
            if rec.moved_bytes:
                self.metrics.counter("migrated_bytes", kind="blocking").inc(
                    rec.moved_bytes)
            if rec.background_bytes:
                self.metrics.counter("migrated_bytes", kind="background").inc(
                    rec.background_bytes)
            planned, realized = self._compression_ratios(model)
            self.metrics.gauge("compression_ratio_planned").set(planned)
            self.metrics.gauge("compression_ratio_realized").set(realized)
        if self.tracer is not None and self.tracer.enabled:
            if migration is not None:
                for (t0, t1, label) in migration.sim.events:
                    self.tracer.span(
                        CAT_CHECKPOINT if "ckpt" in label else CAT_MIGRATION,
                        label, "migration", clock_before + t0,
                        clock_before + t1, args={"epoch": rec.epoch})
            self.tracer.instant(
                CAT_CONTROLLER, f"epoch:{rec.cause}", "controller",
                t=self.clock,
                args={"epoch": rec.epoch, "step": rec.at_step,
                      "mode": rec.replan_mode,
                      "stage_devices": list(rec.stage_devices)})

    def _compression_ratios(self, model: EdgeCostModel
                            ) -> Tuple[float, float]:
        """(planned, realized) aggregate compression over the installed
        plan's cross edges: planned is Σdense / Σ(dense/ratio) — what the
        plan asked for; realized is Σdense / Σwire at the exact integer wire
        encoding — what the wire actually carries (index overhead included).
        Both 1.0 for an uncompressed epoch."""
        dense = asked = wire = 0.0
        for (a, n) in model.cross_edges(self.schedule.placement):
            d = model.dense_bytes(a)
            dense += d
            asked += d / max(model.ratio(a, n), 1.0)
            wire += model.edge_wire_bytes(a, n)
        if dense <= 0.0:
            return 1.0, 1.0
        return dense / max(asked, 1e-12), dense / max(wire, 1e-12)

    def _cur_step(self) -> int:
        """Data step the run loop last completed (0 before any step)."""
        return self.step_records[-1].step if self.step_records else 0

    @property
    def epoch(self) -> int:
        return len(self.epoch_records) - 1

    # -------------------------------------------------------------- run ----
    def run(self, steps: int,
            data_fn: Optional[Callable[[int], Sequence[Mapping]]] = None,
            params: Any = None) -> ElasticRunResult:
        """Train (or simulate) ``steps`` useful data steps through churn.

        ``data_fn(step)`` must return the micro-batch list for that data step
        deterministically — after a rollback the controller replays step
        indices and must see identical batches.  ``params`` starts training;
        with ``data_fn=None`` the controller runs timing-only.
        """
        train = data_fn is not None
        if train and (params is None or self.optimizer is None):
            raise ValueError("training mode needs params and an optimizer")
        opt_state = self.optimizer.init(params) if train else None
        ckpts: List[_Checkpoint] = [_Checkpoint(
            step=0, clock=self.clock,
            blob=serialize_state(params, opt_state) if train else None)]

        step = 0          # next data step to execute
        while step < steps:
            loss_val = None
            if train:
                mbs = data_fn(step)
                loss, grads = self.runtime.train_step(params, mbs)
                params, opt_state = self.optimizer.update(grads, opt_state,
                                                          params)
                del grads    # consumed: not held through the next step
                loss_val = float(loss)
            sim_time = self._step_timing(step)
            self.clock += sim_time
            if self.watchdog is not None:
                self.watchdog.observe_step(step, self.clock, sim_time)
            step += 1
            self.step_records.append(StepRecord(
                step=step, epoch=self.epoch, loss=loss_val,
                step_seconds=sim_time, clock=self.clock,
                overlapping=self._migrating is not None))
            if self.metrics is not None:
                self.metrics.histogram("step_seconds").observe(sim_time)
                ef = self.runtime.ef_state
                if ef:
                    for a in sorted(ef):
                        self.metrics.gauge("ef_residual_norm", edge=a).set(
                            float(torch.linalg.vector_norm(ef[a])))
            # a degraded node shows up as aggregated telemetry > prediction
            self.detector.observe(self.telemetry.node_step_times())
            self._steps_since_fit += 1
            if step % self.checkpoint_interval == 0:
                # the oldest goes before the new one is written: the same
                # history as appending then trimming, without holding
                # checkpoint_history + 1 blobs of the whole state at once
                del ckpts[:max(0, len(ckpts) - self.checkpoint_history + 1)]
                ckpts.append(_Checkpoint(
                    step=step, clock=self.clock,
                    blob=serialize_state(params, opt_state) if train
                    else None))

            transition = None
            if self._migrating is not None:
                self._migrating.progressed += sim_time
                if self._migrating.progressed >= self._migrating.bg_seconds:
                    params, opt_state = self._cutover(
                        params, opt_state, train, residual=0.0, at_step=step)
                else:
                    # a membership change mid-stream forces the cut-over
                    # (residual charged blocking), then is handled normally;
                    # recover announcements that ripen mid-stream are
                    # deferred for the next _pending_transition poll
                    deltas = self.membership.poll(self.clock)
                    self._deferred_deltas.extend(
                        d for d in deltas if d.event.kind == "recover")
                    member = [d for d in deltas
                              if d.event.kind in ("leave", "join")]
                    if member:
                        residual = (self._migrating.bg_seconds
                                    - self._migrating.progressed)
                        params, opt_state = self._cutover(
                            params, opt_state, train, residual=residual,
                            at_step=step)
                        cause = "failure" if any(
                            d.event.kind == "leave" for d in member) \
                            else "join"
                        transition = (cause, member)
            else:
                transition = self._pending_transition()
            if transition is None:
                continue
            cause, deltas = transition
            dead = [d.event.node for d in deltas if d.event.kind == "leave"]
            detect_s = max((self.clock - d.event.time for d in deltas),
                           default=0.0)

            rollback_steps = 0
            failure_times = [d.event.time for d in deltas
                             if d.event.kind == "leave"]
            need_rollback = bool(failure_times) and any(
                self.schedule.assignment[n] for n in dead)
            if need_rollback:
                # state shards on the dead node are gone: recover from the
                # newest checkpoint that predates the failure
                t_fail = min(failure_times)
                valid = [c for c in ckpts if c.clock <= t_fail]
                if not valid:
                    raise RuntimeError(
                        "no checkpoint predates the failure — raise "
                        "checkpoint_history or lower checkpoint_interval")
                ck = valid[-1]
                rollback_steps = step - ck.step
                if train:
                    params, opt_state = deserialize_state(ck.blob, params,
                                                          opt_state)
                for r in self.step_records:
                    if r.step > ck.step:
                        r.lost = True
                step = ck.step
                ckpts = [c for c in ckpts if c.step <= ck.step]

            joined = [d.event.node for d in deltas if d.event.kind == "join"]
            rp = self._replan(dead, joined)
            plan_only = False
            if cause == "calibration":
                same_assign = \
                    rp.schedule.assignment == self.schedule.assignment
                new_plan = self.plan_factory(self.graph, self.profiles,
                                             self.believed_cluster(),
                                             rp.schedule.placement)
                if same_assign and new_plan == self.plan:
                    # calibration confirmed the active plan (schedule AND
                    # compression) is still the best response — no epoch
                    # change, no migration, no refill
                    self._record_replan(step, cause, dead, joined, rp,
                                        plan_only=False, confirmed=True)
                    continue
                # same cut, re-allocated compression: a hot plan swap moves
                # no state and never stalls the pipeline
                plan_only = same_assign
            self._record_replan(step, cause, dead, joined, rp,
                                plan_only=plan_only)
            if self.migration_mode == "overlap":
                self._begin_overlap(rp, cause=cause,
                                    events=[d.event for d in deltas],
                                    dead=dead, at_step=step,
                                    detect_seconds=detect_s,
                                    rollback_steps=rollback_steps)
            else:
                if train:
                    live = [m for m in rp.migration.moves
                            if not m.from_checkpoint]
                    before = params
                    out = apply_moves(params, opt_state, live)
                    assert_bitexact(before, out.params, "migrated params")
                    params, opt_state = out.params, out.opt_state
                    del before, out
                self._install_schedule(cause=cause,
                                       events=[d.event for d in deltas],
                                       dead=dead, at_step=step,
                                       detect_seconds=detect_s,
                                       migration=rp.migration,
                                       rollback_steps=rollback_steps,
                                       replan_mode=rp.mode,
                                       schedule=rp.schedule,
                                       charge_refill=not plan_only)
        return ElasticRunResult(steps=self.step_records,
                                epochs=self.epoch_records,
                                params=params, opt_state=opt_state,
                                total_seconds=self.clock)

    # --------------------------------------------------- overlap machinery --
    def _begin_overlap(self, rp: ReplanResult, cause: str,
                       events: List[ChurnEvent], dead: Sequence[int],
                       at_step: int, detect_seconds: float,
                       rollback_steps: int) -> None:
        """Start an overlapped migration toward ``rp.schedule``.

        Blocking phase (foreground, training stopped): only the dead
        CompNodes' shards, streamed from the checkpoint store into the
        interim schedule's hosts.  Everything else drains in the background
        while training continues on the interim (or unchanged old) schedule
        over bandwidth-shared links; `_cutover` finishes the epoch change.

        Stream-vs-keep decision: streaming only pays when the target's
        steady-state pace covers the foreground slowdown during the stream
        within ``amortize_steps`` — fair-share conservation means bytes
        crossing the pipeline's own bottleneck wire cannot be hidden, so a
        pace-equivalent target is not worth migrating to at all and the
        interim schedule simply becomes the epoch's schedule
        (``replan_mode="interim-final"``).
        """
        old = self.schedule
        believed = self.believed_cluster()
        dead_with_ops = [d for d in dead if old.assignment[d]]
        if dead_with_ops:
            interim = interim_schedule(self.graph, old, dead,
                                       len(self.base_cluster))
            if interim is None:
                raise RuntimeError("no surviving stage to host the interim "
                                   "schedule")
            # only the dead segments differ between old and interim, so the
            # diff is exactly the blocking checkpoint-restore set
            blocking = diff_schedules(old, interim, self.profiles, dead=dead,
                                      opt_state_mult=self.opt_state_mult)
            migration = MigrationPlan(
                moves=blocking,
                sim=simulate_migration(_group_transfers(blocking), believed))
            charge_refill = True          # rollback left the pipeline cold
        else:
            interim = old                 # pipeline keeps running warm
            migration, charge_refill = None, False

        moves = diff_schedules(interim, rp.schedule, self.profiles,
                               dead=(), opt_state_mult=self.opt_state_mult)
        stream = None
        if moves:
            bg_sim = simulate_migration(
                _group_transfers(moves), believed,
                bandwidth_fraction=1.0 - self.overlap_bandwidth_share)
            # the stream contends per link: only the wires it actually
            # rides slow the foreground (a bulk flow on a fast intra-cluster
            # link must not throttle the WAN edge bounding the pipeline)
            busy = tuple(sorted({(m.src, m.dst) for m in moves
                                 if m.src is not None}))
            if self._stream_pays_off(interim, rp.schedule, believed, busy,
                                     bg_sim.seconds):
                stream = _OverlapState(
                    target=rp.schedule, replan_mode=rp.mode, moves=moves,
                    bg_seconds=bg_sim.seconds, busy=busy)
        self._install_schedule(
            cause=cause, events=events, dead=dead, at_step=at_step,
            detect_seconds=detect_seconds, migration=migration,
            rollback_steps=rollback_steps,
            replan_mode="interim" if stream is not None else "interim-final",
            schedule=interim, charge_refill=charge_refill)
        self._migrating = stream
        self._obs_cache = None   # foreground now runs on shared links

    def _stream_pays_off(self, interim: Schedule, target: Schedule,
                         believed: ClusterSpec,
                         busy: Tuple[Tuple[int, int], ...],
                         bg_seconds: float) -> bool:
        """Broker-side cost model (on the believed topology): stream when
        ``slowdown_waste + amortize_steps · pace(target)`` beats
        ``amortize_steps · pace(interim)``."""
        def pace(schedule: Schedule, cluster: ClusterSpec) -> float:
            plan = self.plan_factory(self.graph, self.profiles, believed,
                                     schedule.placement)
            return simulate_iteration(
                self.graph, self.profiles, schedule, cluster,
                n_micro=self.n_micro,
                cost_model=self.believed_model(cluster, plan)
            ).iteration_time

        t_interim = pace(interim, believed)
        t_target = pace(target, believed)
        t_shared = pace(interim, with_shared_links(
            believed, busy, self.overlap_bandwidth_share))
        n_stream_steps = bg_seconds / max(t_shared, 1e-12)
        waste = n_stream_steps * (t_shared - t_interim)
        return (waste + self.amortize_steps * t_target
                < self.amortize_steps * t_interim)

    def _cutover(self, params: Any, opt_state: Any, train: bool,
                 residual: float, at_step: int) -> Tuple[Any, Any]:
        """Finish an overlapped migration: charge the residual stream time
        (blocking), install the target schedule, and apply the background
        moves bit-exactly.

        No refill is charged here: a cut-over is a *hot* hand-off between
        two warm schedules at a step boundary, and the per-step simulator
        already replays a full GPipe fill+drain every iteration — unlike the
        blocking path, where the whole pipeline sat empty during the stall.
        """
        mig = self._migrating
        self._migrating = None
        if train:
            before = params
            out = apply_moves(params, opt_state, mig.moves)
            assert_bitexact(before, out.params, "migrated params")
            params, opt_state = out.params, out.opt_state
        self._install_schedule(
            cause="cutover", events=[], dead=[], at_step=at_step,
            detect_seconds=0.0,
            migration=MigrationPlan(moves=mig.moves, sim=simulate_migration(
                {}, self.base_cluster)),
            rollback_steps=0, replan_mode=mig.replan_mode,
            schedule=mig.target, migrate_seconds=residual,
            charge_refill=False,
            background_bytes=float(sum(m.nbytes for m in mig.moves)),
            overlap_seconds=min(mig.progressed, mig.bg_seconds))
        return params, opt_state

    def _step_timing(self, step: int) -> float:
        """Simulated iteration seconds under the ground-truth cluster (shared
        links while a background migration streams).  The simulator's
        per-stage StepTiming samples are recorded into the broker telemetry,
        stamped with the data step.  Pure function of (schedule, true
        slowdowns, background-busy set), which only change at churn events
        or re-plans — cached so the per-step hot loop skips the sweeps."""
        busy = self._migrating.busy if self._migrating is not None else ()
        key = (tuple(sorted(self.membership.slow_factor.items())),
               tuple(sorted(self.membership.link_factor.items())), busy)
        tracing = self.tracer is not None and self.tracer.enabled
        if self._obs_cache is None or self._obs_cache[0] != key:
            true_cl = self.true_cluster()
            if busy:
                true_cl = with_shared_links(
                    true_cl, busy, self.overlap_bandwidth_share)
            sink = TelemetrySink()
            # spans are captured once per regime into a local recorder at a
            # zero origin and replayed per step at the step's clock offset —
            # the simulator itself runs identically with tracing on or off
            span_rec = TraceRecorder() if tracing else None
            # ground-truth codec pricing: the sim charges what encode really
            # costs on each host (kernel_costs), never the broker's belief
            true_model = EdgeCostModel(
                self.graph, self.profiles, true_cl, self.plan,
                kernel_costs=self.kernel_costs) if self.kernel_costs else None
            sim = simulate_iteration(self.graph, self.profiles, self.schedule,
                                     true_cl, self.plan,
                                     n_micro=self.n_micro, telemetry=sink,
                                     trace=span_rec, cost_model=true_model)
            busy_totals = (float(sum(sim.device_busy)),
                           float(sim.link_busy),
                           float(sim.compress_busy))
            self._obs_cache = (key, sim.iteration_time, sink.samples,
                               sink.link_samples, sink.kernel_samples,
                               tuple(span_rec.events()) if span_rec else (),
                               busy_totals)
        (_, sim_time, samples, link_samples, kernel_samples, spans,
         busy_totals) = self._obs_cache
        if self.metrics is not None:
            # the simulator's own busy accounting, accumulated per step:
            # the critpath CLI's --expect-busy gate checks the trace-derived
            # attribution against these totals (CI fails on >1% drift)
            dev_busy, link_busy, codec_busy = busy_totals
            self.metrics.counter("sim_device_busy_seconds").inc(dev_busy)
            self.metrics.counter("sim_link_busy_seconds").inc(link_busy)
            self.metrics.counter("sim_compress_busy_seconds").inc(codec_busy)
        if tracing and spans:
            # (step, epoch) identifies one execution attempt: after a
            # rollback the same data step re-executes under the next epoch,
            # and the happens-before checker must not pair spans across the
            # two attempts
            self.tracer.replay(spans, dt=self.clock,
                               extra_args={"step": step,
                                           "epoch": len(self.epoch_records)})
        self.telemetry_bus.record_step(samples, step=step)
        # codec samples are device-local compute — unaffected by stream
        # contention on the wire, so they record even while migrating
        self.telemetry_bus.record_kernel_step(kernel_samples, step=step)
        if self._migrating is None:
            # link observations taken while a background stream contends on
            # the wire measure the (transient) shared bandwidth, not the
            # link's truth — calibrating on them would thrash
            self.telemetry_bus.record_link_step(link_samples, step=step)
        return sim_time

    # ------------------------------------------------------- transitions ---
    def _pending_transition(self):
        """Poll membership + detector; decide whether an epoch change is due.
        Returns (cause, deltas) or None."""
        deltas = self._deferred_deltas + self.membership.poll(self.clock)
        self._deferred_deltas = []
        member_deltas = [d for d in deltas
                         if d.event.kind in ("leave", "join")]
        if member_deltas:
            cause = "failure" if any(d.event.kind == "leave"
                                     for d in member_deltas) else "join"
            return cause, member_deltas
        flagged = {d: f for d, f in self.detector.believed_factors().items()
                   if self.believed_factors.get(d) is None}
        if flagged:
            self.believed_factors.update(flagged)
            if self.metrics is not None:
                self.metrics.counter("detector_trips").inc(len(flagged))
            for d, f in sorted(flagged.items()):
                if self.flight is not None:
                    self.flight.log(DetectorRecord(
                        step=self._cur_step(), clock=self.clock, node=int(d),
                        severity=float(self.detector.severity(d)),
                        believed_factor=float(f)))
                if self.tracer is not None and self.tracer.enabled:
                    self.tracer.instant(
                        CAT_CONTROLLER, f"detector:flag dev{int(d)}",
                        "controller", t=self.clock,
                        args={"node": int(d), "believed_factor": float(f)})
            return "straggler", []
        recovered = self._rehabilitated()
        # a node drained of ops has no observable stage time; trust its own
        # recovery announcement (the membership view surfaces the event)
        recovered += [d.event.node for d in deltas
                      if d.event.kind == "recover"
                      and d.event.node in self.believed_factors
                      and d.event.node not in recovered
                      and self.detector.stats.get(d.event.node) is None]
        if recovered:
            for d in recovered:
                del self.believed_factors[d]
            return "recovery", []
        if self._calibration_due():
            return "calibration", []
        return None

    # ------------------------------------------------------- calibration ---
    def _calibration_due(self) -> bool:
        """Run the periodic auto-calibration when its window has elapsed;
        True when the newly calibrated belief diverges from the active plan
        far enough that a re-plan is warranted."""
        if not self.calibrate_interval:
            return False
        if self._steps_since_fit < self.calibrate_interval:
            return False
        self._steps_since_fit = 0
        return self._calibrate()

    def _calibrate(self) -> bool:
        """Fit per-link corrections and per-device codec costs from the
        telemetry window and fold the survivors into the broker's belief.

        The fit always runs against the *uncorrected* base spec
        (``base_cluster``) — corrections are absolute and replace what is
        installed, so repeated re-fits converge on the measured ratio instead
        of compounding through the clamp (see
        :func:`repro_torch.core.costmodel.fit_link_corrections`).  Hysteresis: a
        fitted value within ``calibrate_hysteresis`` (relative) of the
        installed one is noise, not drift — ignored, so a single noisy
        window cannot thrash the schedule.  Values that return to within the
        band of 1.0 drop their correction outright (the link healed).

        On any accepted change the detector is *repriced* in place (same
        schedule, new reference — EWMA history survives) and the active
        plan's calibrated pace is compared against the pace it was installed
        at: divergence beyond ``replan_pace_margin`` returns True, which the
        transition poll turns into a ``"calibration"`` epoch change.
        """
        samples = self.telemetry.link_samples(
            min_steps=self.calibrate_min_samples)
        kernel_window = self.telemetry.kernel_samples(
            min_steps=self.calibrate_min_samples)
        if not samples and not kernel_window:
            return False
        fitted = fit_link_corrections(samples, self.base_cluster) \
            if samples else {}
        changed = False
        verdicts: Dict[Tuple[int, int], str] = {}
        for lk in sorted(fitted):
            new = fitted[lk]
            old = self.link_corrections.get(lk, 1.0)
            if abs(new - old) <= self.calibrate_hysteresis * old:
                verdicts[lk] = "hysteresis"
                continue
            if abs(new - 1.0) <= self.calibrate_hysteresis:
                self.link_corrections.pop(lk, None)
                verdicts[lk] = "healed"
            else:
                self.link_corrections[lk] = new
                verdicts[lk] = "adopted"
            changed = True
        # per-device codec costs, same hysteresis discipline on the fitted
        # throughput: the first fit always installs (belief moves from "free"
        # to measured), later fits only when they drift past the band
        for dev, kc in sorted(fit_kernel_costs(kernel_window).items()):
            old_kc = self.kernel_cost_belief.get(dev)
            if old_kc is not None and abs(
                    kc.bytes_per_second - old_kc.bytes_per_second) \
                    <= self.calibrate_hysteresis * old_kc.bytes_per_second:
                continue
            self.kernel_cost_belief[dev] = kc
            changed = True
        installed_pace_before = self._installed_pace
        diverged = False
        pace = installed_pace_before
        if changed:
            self.calibration_count += 1
            believed = self.believed_cluster()
            model = self.believed_model(believed)
            self.detector.reprice(
                predict_step_times(self.graph, self.profiles, believed,
                                   self.schedule.placement, cost_model=model))
            pace = model.stage_pace(self.schedule)
            diverged = self._installed_pace > 0.0 and \
                pace > (1.0 + self.replan_pace_margin) * self._installed_pace
            # re-arm on the freshly calibrated pace either way: the next
            # trigger needs *further* divergence, not the same one
            # re-observed every window (and a re-plan that keeps the
            # schedule must not loop)
            self._installed_pace = pace
        if changed and self.metrics is not None:
            self.metrics.counter("calibration_fits").inc()
            for lk, v in sorted(self.link_corrections.items()):
                self.metrics.gauge("link_correction",
                                   link=f"{lk[0]}->{lk[1]}").set(float(v))
            for dev, kc in sorted(self.kernel_cost_belief.items()):
                self.metrics.gauge("kernel_bytes_per_second", node=dev).set(
                    float(kc.bytes_per_second))
        if self.flight is not None:
            self.flight.log(CalibrationRecord(
                step=self._cur_step(), clock=self.clock,
                window=links_to_str({k: len(v) for k, v in samples.items()}),
                fitted=links_to_str({k: float(v)
                                     for k, v in fitted.items()}),
                verdicts=links_to_str(verdicts),
                installed=links_to_str({k: float(v) for k, v in
                                        self.link_corrections.items()}),
                repriced=changed, installed_pace=installed_pace_before,
                calibrated_pace=pace, diverged=diverged))
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                CAT_CONTROLLER, "calibration", "controller", t=self.clock,
                args={"fitted": links_to_str({k: round(float(v), 4)
                                              for k, v in fitted.items()}),
                      "repriced": changed, "diverged": diverged})
        return diverged

    def _rehabilitated(self) -> List[int]:
        """Believed-degraded nodes whose observations say they are healthy
        again.  The detector predicts with the *believed* (degraded) speed,
        so a fully recovered node shows severity ≈ its believed factor f
        (observed = believed_prediction · f); severity near or below f means
        the degradation is gone."""
        out = []
        for d, f in list(self.believed_factors.items()):
            st = self.detector.stats.get(d)
            if (st is not None and st.count >= self.detector.min_observations
                    and self.detector.severity(d) <= f * 1.05):
                out.append(d)
        return out

    def _replan_reason(self, cause: str, dead: Sequence[int],
                       joined: Sequence[int]) -> str:
        """Human-readable trigger description for the flight log."""
        if cause == "failure":
            return f"lease expired: dead={sorted(int(d) for d in dead)}"
        if cause == "join":
            return f"admitted: joined={sorted(int(j) for j in joined)}"
        if cause == "straggler":
            flags = {int(d): round(float(f), 3)
                     for d, f in sorted(self.believed_factors.items())}
            return f"detector flagged believed factors {flags}"
        if cause == "recovery":
            return "believed stragglers rehabilitated"
        if cause == "calibration":
            return (f"calibrated pace of active plan diverged more than "
                    f"{self.replan_pace_margin:.0%} past its installed pace")
        return cause

    def _record_replan(self, at_step: int, cause: str, dead: Sequence[int],
                       joined: Sequence[int], rp: ReplanResult,
                       plan_only: bool, confirmed: bool = False) -> None:
        """One flight record per re-plan decision, every candidate priced —
        including the zero-migration ``keep`` when it was offered."""
        if self.flight is None and (
                self.tracer is None or not self.tracer.enabled):
            return
        reason = self._replan_reason(cause, dead, joined)
        if confirmed:
            reason += " (confirmed: same cut and plan — no epoch change)"
        if self.flight is not None:
            self.flight.log(ReplanRecord(
                step=at_step, clock=self.clock, cause=cause, reason=reason,
                dead=sorted(int(d) for d in dead),
                joined=sorted(int(j) for j in joined),
                candidates=[CandidateScore(**s) for s in rp.scores],
                winner=rp.mode, plan_only=plan_only))
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                CAT_CONTROLLER, f"replan:{cause}", "controller", t=self.clock,
                args={"winner": rp.mode, "reason": reason,
                      "scores": {s["name"]: round(s["score"], 6)
                                 for s in rp.scores}})

    def _replan(self, dead: Sequence[int],
                joined: Sequence[int] = ()) -> ReplanResult:
        for d in dead:
            self.believed_factors.pop(d, None)
        believed = self.believed_cluster()
        # re-plan under the epoch's compression plan AND the calibrated link
        # corrections: boundaries that persist across the re-cut keep their
        # compressed byte costs (edges the old plan never keyed fall back to
        # dense — the next epoch's plan_factory re-compresses them), and
        # every candidate is priced on the links as measured, not as spec'd
        model = self.believed_model(believed)
        return replan(self.graph, self.profiles, believed,
                      self.schedule, alive=self.membership.alive, dead=dead,
                      joined=joined, seed=self.seed,
                      opt_state_mult=self.opt_state_mult,
                      cost_model=model, mode=self.replan_mode,
                      amortize_steps=self.amortize_steps,
                      pin_boundaries=self.pin_boundaries,
                      planner=self.planner, joint_ratio=self.joint_ratio,
                      verify=self.verify)
