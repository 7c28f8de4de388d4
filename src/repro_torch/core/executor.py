"""DAG runtime executor + discrete-event timing simulator (FusionLLM §3.2–3.3).

Two layers:

* :class:`DecentralizedRuntime` — the *functional* executor.  Every CompNode
  owns a sub-DAG, a mailbox, and its slice of the parameters; OpData
  envelopes (paper §3.4) carry boundary activations/gradients between
  CompNodes; FP/BP use the stage-local autodiff of
  :mod:`repro_torch.core.rad`.  Numerics are exact (one process on one
  device stands in for the swarm).

* :func:`simulate_iteration` — the *timing* simulator.  Discrete-event
  replay of the GPipe schedule (Eq. 3) at stage granularity with separate
  compute and link resources, heterogeneous α–β links and per-edge
  compression; this is what the paper's Fig. 10 latency numbers correspond
  to, since real wall-time over the Internet cannot be measured here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .compression import CompressionPlan, plan_none
from .costmodel import EdgeCostModel
from .estimator import ClusterSpec
from .opgraph import OpData, OpGraph, OpProfile, OpType
from .rad import (PipelineProgram, init_ef_state, pipeline_loss_and_grad,
                  pipeline_loss_and_grad_ef, tree_map)
from .scheduler import Schedule
from ..obs.trace import CAT_BWD, CAT_ENCODE, CAT_FWD, CAT_TRANSFER


# ========================================================== telemetry hook ==
@dataclasses.dataclass(frozen=True)
class StepTiming:
    """One per-stage, per-micro-batch timing sample.

    Emitted by :func:`simulate_iteration` (simulated seconds) and by
    :class:`DecentralizedRuntime` (measured host wall-clock); consumed by the
    broker-side :class:`repro.elastic.telemetry.TelemetryLog`, which
    aggregates samples into the per-CompNode step times the straggler
    detector observes.  ``comm_seconds`` is charged to the stage owning the
    *consumer* op of each cross-stage edge in both passes — the same
    attribution :func:`repro.core.estimator.predict_step_times` uses, so
    telemetry observations and estimator predictions are directly comparable.
    """

    node: int                  # CompNode (device) index
    stage: int                 # pipeline stage position
    micro_batch: int
    backward: bool
    compute_seconds: float
    comm_seconds: float = 0.0
    step: int = 0              # training step the sample belongs to

    @property
    def seconds(self) -> float:
        return self.compute_seconds + self.comm_seconds


@dataclasses.dataclass(frozen=True)
class LinkTiming:
    """One per-link transfer observation: ``nbytes`` rode the directed
    (src, dst) CompNode link and took ``seconds`` on the wire.

    Emitted by :func:`simulate_iteration` alongside :class:`StepTiming` (one
    sample per cross-stage edge transfer, per micro-batch, per direction).
    This is the raw material of closed-loop link calibration: the broker's
    :class:`repro.elastic.telemetry.TelemetryLog` windows and MAD-filters
    these into the ``(nbytes, seconds)`` pairs that
    :func:`repro.core.costmodel.fit_link_corrections` turns into per-link
    corrections on the planner's α–β model.
    """

    src: int                   # producer-side CompNode (device) index
    dst: int                   # consumer-side CompNode (device) index
    nbytes: float              # exact wire bytes of the transfer
    seconds: float             # observed transport seconds on the link
    backward: bool = False
    step: int = 0


@dataclasses.dataclass(frozen=True)
class KernelTiming:
    """One compression-codec observation: the fused encode(+EF) kernel on
    CompNode ``node`` chewed through ``nbytes`` of *dense* payload in
    ``seconds`` of compute.

    Emitted by :func:`simulate_iteration` (one sample per compressed edge
    transfer, priced by the model's :class:`~repro.core.costmodel.
    KernelCostModel`) and by :class:`DecentralizedRuntime` (measured host
    wall-clock around the traced codec).  The broker's TelemetryLog windows
    and MAD-filters these into the ``(dense_bytes, seconds)`` pairs
    :func:`repro.core.costmodel.fit_kernel_costs` turns into per-device
    codec costs — closing the same loop link calibration closes for α–β.
    ``nbytes`` is dense payload, not wire bytes: codec time scales with
    what the kernel reads, not with what survives compression."""

    node: int                  # CompNode (device) index running the codec
    nbytes: float              # dense payload bytes through the kernel
    seconds: float             # codec compute seconds
    backward: bool = False
    step: int = 0


class TelemetrySink:
    """Anything with ``record(StepTiming)`` (and optionally
    ``record_link(LinkTiming)`` / ``record_kernel(KernelTiming)``); the
    trivial list-backed sink."""

    def __init__(self):
        self.samples: List[StepTiming] = []
        self.link_samples: List[LinkTiming] = []
        self.kernel_samples: List[KernelTiming] = []

    def record(self, sample: StepTiming) -> None:
        self.samples.append(sample)

    def record_link(self, sample: LinkTiming) -> None:
        self.link_samples.append(sample)

    def record_kernel(self, sample: KernelTiming) -> None:
        self.kernel_samples.append(sample)


# ===================================================== functional executor ==
class CompNodeRuntime:
    """One participant: holds its sub-DAG's params and a mailbox of OpData."""

    def __init__(self, device_index: int, stage_index: int):
        self.device_index = device_index
        self.stage_index = stage_index
        self.mailbox: List[OpData] = []
        self.sent_log: List[OpData] = []

    def deliver(self, msg: OpData) -> None:
        self.mailbox.append(msg)

    def pop_activations(self, needed: Sequence[str], micro_batch: int
                        ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for m in self.mailbox:
            if (not m.is_loss and m.actual_op_user is None
                    and m.name in needed and m.micro_batch == micro_batch):
                out[m.name] = m.payload
        missing = set(needed) - set(out)
        if missing:
            raise RuntimeError(f"CompNode {self.device_index} missing "
                               f"activations {sorted(missing)}")
        return out


class DecentralizedRuntime:
    """End-to-end FusionLLM runtime over a Schedule (broker's output).

    ``train_step`` runs n_micro micro-batches through FP+BP with per-edge
    compression and returns (mean loss, accumulated grads, OpData traffic
    log).  Gradient identity: messages with ``actual_op_user`` set are
    boundary gradients keyed producer->user (paper Table 3).

    ``plan.error_feedback=True`` dispatches to the EF-SGD gradient transport
    (:func:`repro.core.rad.pipeline_loss_and_grad_ef`); the residual memory
    lives on the runtime and carries across micro-batches and steps.

    ``telemetry`` (anything with ``record(StepTiming)``) receives one
    measured-wall-clock sample per (stage, micro-batch, direction) — the
    real-executor observation source for the broker's straggler detector.

    ``device`` (default ``"cuda"``; a missing card raises) is where the
    micro-batches go: numpy arrays or tensors are moved there.  Parameters
    are the caller's, already on that device.
    """

    def __init__(self, graph: OpGraph, schedule: Schedule,
                 plan: Optional[CompressionPlan] = None,
                 use_kernel: Any = False,
                 telemetry: Optional[Any] = None,
                 trace: Optional[Any] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        self.schedule = schedule
        self.plan = plan or plan_none(graph, schedule.placement)
        self.use_kernel = use_kernel
        self.prog = PipelineProgram.build(graph, schedule.pipeline_subdags(graph))
        self.comp_nodes = [CompNodeRuntime(dev, s)
                           for s, dev in enumerate(schedule.stage_devices())]
        self.traffic: List[OpData] = []
        self.telemetry = telemetry
        self.trace = trace
        self.ef_state: Optional[Dict[str, torch.Tensor]] = None
        self.step_index = 0

    def _log(self, msg: OpData) -> None:
        self.traffic.append(msg)

    def _timing_cb(self, mb_idx: int):
        trace = self.trace if getattr(self.trace, "enabled", False) else None
        if self.telemetry is None and trace is None:
            return None
        devs = self.schedule.stage_devices()

        def cb(stage: int, backward: bool, seconds: float) -> None:
            if self.telemetry is not None:
                self.telemetry.record(StepTiming(
                    node=devs[stage], stage=stage, micro_batch=mb_idx,
                    backward=backward, compute_seconds=seconds,
                    step=self.step_index))
            if trace is not None:
                trace.complete_wall(
                    CAT_BWD if backward else CAT_FWD,
                    f"{'B' if backward else 'F'}{stage}.mb{mb_idx}",
                    f"dev{devs[stage]}", seconds,
                    args={"stage": stage, "mb": mb_idx,
                          "step": self.step_index})
        return cb

    def _kernel_cb(self, mb_idx: int):
        """Measured codec-time hook -> KernelTiming samples, only when the
        sink can absorb them (forcing device sync for nobody is not free)."""
        if self.telemetry is None \
                or not hasattr(self.telemetry, "record_kernel"):
            return None
        devs = self.schedule.stage_devices()

        def cb(stage: int, backward: bool, seconds: float,
               dense_bytes: float) -> None:
            self.telemetry.record_kernel(KernelTiming(
                node=devs[stage], nbytes=dense_bytes, seconds=seconds,
                backward=backward, step=self.step_index))
        return cb

    def _to_device(self, mb: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in mb.items()}

    def train_step(self, params: Mapping[str, Any],
                   micro_batches: Sequence[Mapping[str, Any]]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        total = None
        acc: Optional[Dict[str, Any]] = None
        for mb_idx, mb in enumerate(micro_batches):
            mb = self._to_device(mb)
            cb = self._timing_cb(mb_idx)
            kcb = self._kernel_cb(mb_idx)
            if self.plan.error_feedback:
                if self.ef_state is None:
                    self.ef_state = init_ef_state(self.prog, params, mb)
                loss, grads, self.ef_state = pipeline_loss_and_grad_ef(
                    self.prog, params, mb, self.plan, self.ef_state,
                    self.use_kernel, timing_cb=cb, trace=self.trace,
                    kernel_cb=kcb)
            else:
                loss, grads = pipeline_loss_and_grad(
                    self.prog, params, mb, self.plan, self.use_kernel,
                    timing_cb=cb, trace=self.trace, kernel_cb=kcb)
            # traffic accounting (envelope per cross-stage edge, FP + BP)
            for si, sd in enumerate(self.prog.subdags):
                for a in sd.required_acti:
                    self._log(OpData(name=a,
                                     op_users=tuple(self.graph.users[a]),
                                     micro_batch=mb_idx,
                                     compress_cfg={"ratio": self._edge_ratio(a, sd)}))
                for (prod, user) in sd.send_grad:
                    self._log(OpData(name=prod, op_users=(user,),
                                     actual_op_user=user, micro_batch=mb_idx,
                                     compress_cfg={"ratio": self.plan.ratio(prod, user)}))
            total = loss if total is None else total + loss
            acc = grads if acc is None else tree_map(torch.add, acc, grads)
        n = float(len(micro_batches))
        self.step_index += 1
        return total / n, tree_map(lambda g: g / n, acc)

    def _edge_ratio(self, producer: str, sd) -> float:
        cs = [n for n in sd.node_names if producer in self.graph.nodes[n].args]
        return max([self.plan.ratio(producer, c) for c in cs] or [1.0])


# ======================================================= timing simulator ==
@dataclasses.dataclass
class SimResult:
    iteration_time: float
    fwd_time: float
    bwd_time: float
    device_busy: List[float]
    link_busy: float
    comm_bytes: float
    events: List[Tuple[float, float, str]]  # (start, end, label)
    compress_busy: float = 0.0  # codec-stream seconds (0 unless the model
                                # carries calibrated kernel costs)

    @property
    def utilization(self) -> List[float]:
        t = max(self.iteration_time, 1e-12)
        return [b / t for b in self.device_busy]


def _stage_tables(graph: OpGraph, profiles: Mapping[str, OpProfile],
                  schedule: Schedule, cluster: ClusterSpec,
                  model: EdgeCostModel, backward: bool):
    """Per-stage compute seconds + boundary (bytes, link) into each stage.

    All transported bytes/seconds come from the unified ``model`` (the plan's
    exact wire encoding at the producer's dtype plus α–β link seconds), so
    simulated comm charges agree with the estimator's prediction exactly."""
    placement = schedule.placement
    stages = [d for d in schedule.stages if schedule.assignment[d]]
    comp = []
    for d in stages:
        flops = sum((profiles[n].bwd_flops if backward else profiles[n].fwd_flops)
                    for n in schedule.assignment[d])
        comp.append(flops / cluster.devices[d].speed)
    # boundary edges between consecutive stages (chain partition ⇒ boundary
    # traffic flows stage k -> k+1 in FP and back in BP); multi-user edges
    # (e.g. shared attention, cross-attention) may skip stages — each gets
    # its own link transfer.  ``charge`` is the stage owning the consumer op,
    # the stage whose telemetry sample absorbs the transfer time (matching
    # the estimator's recv attribution, see StepTiming).  ``t_enc`` is the
    # codec seconds on the transfer's *source* device (FP: the producer
    # encodes the activation; BP: the consumer encodes the boundary
    # gradient) — zero unless the model carries calibrated kernel costs.
    # (from, to, seconds, charge, wire_bytes, enc_seconds, dense_bytes)
    edges: List[Tuple[int, int, float, int, float, float, float]] = []
    stage_of = {d: i for i, d in enumerate(stages)}
    total_bytes = 0.0
    for n, node in graph.nodes.items():
        for a in node.args:
            if placement[a] == placement[n]:
                continue
            if graph.nodes[a].op_type in (OpType.PLACEHOLDER, OpType.VARIABLE):
                continue
            nbytes = model.edge_wire_bytes(a, n)
            src, dst = placement[a], placement[n]
            if backward:
                src, dst = dst, src
            t = model.link_seconds(src, dst, nbytes)
            t_enc = model.compress_seconds(a, n, src)
            edges.append((stage_of[src], stage_of[dst], t,
                          stage_of[placement[n]], nbytes, t_enc,
                          model.dense_bytes(a)))
            total_bytes += nbytes
    return stages, comp, edges, total_bytes


def simulate_iteration(graph: OpGraph, profiles: Mapping[str, OpProfile],
                       schedule: Schedule, cluster: ClusterSpec,
                       plan: Optional[CompressionPlan] = None,
                       n_micro: int = 1,
                       telemetry: Optional[Any] = None,
                       step: int = 0,
                       cost_model: Optional[EdgeCostModel] = None,
                       trace: Optional[Any] = None) -> SimResult:
    """Discrete-event GPipe replay: FP fills stage by stage per micro-batch,
    then BP drains in reverse.  Each device is a serial resource; each
    directed stage pair is a serial link; compute of micro-batch m+1 overlaps
    the transfer of micro-batch m (the overlap Eq. 3 assumes).

    ``telemetry`` (anything with ``record(StepTiming)``) receives one sample
    per (stage, micro-batch, direction), stamped with ``step`` — the
    simulated stand-in for real per-CompNode executor timings that the
    elastic broker's TelemetryLog aggregates for straggler detection.  A
    sink that additionally exposes ``record_link(LinkTiming)`` also gets one
    sample per cross-stage edge transfer (micro-batch × direction), the raw
    per-link observations closed-loop calibration fits corrections from;
    one that exposes ``record_kernel(KernelTiming)`` gets one sample per
    *compressed* edge transfer when the cost model carries calibrated
    kernel costs (the codec-stream spans, on trace track ``codec<dev>``).
    Compression compute is modeled as a per-boundary span on the source
    device's serial codec stream: it delays the transfer's availability but
    double-buffers against the device's next micro-batch compute
    (``StepTiming.compute_seconds`` excludes it by design — the detector's
    estimator parity is over stage compute + recv only).

    ``cost_model`` supplies the wire encoding (its plan, overriding the
    ``plan`` argument) and any telemetry-calibrated link corrections; by
    default one is built from ``plan``.  Either way the model is rebased
    onto ``cluster`` — compute charges read ``cluster.devices`` directly,
    so comm must price against the same topology or the SimResult would
    silently mix believed and true clusters.

    ``trace`` (a :class:`repro.obs.trace.TraceRecorder`) receives one
    sim-clock span per stage compute window (``stage.fwd``/``stage.bwd`` on
    track ``dev<i>``) and one per boundary transfer (``link.transfer`` on
    track ``link <src>-><dst>``, args carrying exact wire ``nbytes`` and the
    ``charge`` device — the same consumer-side attribution StepTiming uses).
    Tracing is observation only: timings are computed identically with it on
    or off (pinned in tests)."""
    if cost_model is not None:
        model = cost_model.with_cluster(cluster)
    else:
        model = EdgeCostModel(graph, profiles, cluster,
                              plan or plan_none(graph, schedule.placement))

    record_link = getattr(telemetry, "record_link", None)
    record_kernel = getattr(telemetry, "record_kernel", None)
    tracer = trace if getattr(trace, "enabled", False) else None

    def run_pass(backward: bool, t0: float, events, device_free, busy,
                 enc_free):
        stages, comp, edges, nbytes = _stage_tables(
            graph, profiles, schedule, cluster, model, backward)
        k = len(stages)
        order = list(range(k - 1, -1, -1)) if backward else list(range(k))
        in_edges: Dict[int, List[Tuple[int, float, int, float, float, float]]] = {}
        for (s, d2, t, charge, ebytes, t_enc, dbytes) in edges:
            in_edges.setdefault(d2, []).append((s, t, charge, ebytes,
                                                t_enc, dbytes))
        link_free: Dict[Tuple[int, int], float] = {}
        done = {}  # (stage, mb) -> finish time
        comm_total = 0.0
        enc_total = 0.0
        comm_charged: Dict[Tuple[int, int], float] = {}  # (stage, mb) -> s
        cat = CAT_BWD if backward else CAT_FWD
        tag = "B" if backward else "F"
        for mb in range(n_micro):
            for pos, st in enumerate(order):
                dev = stages[st]
                ready = t0
                for (src, tcomm, charge, ebytes, t_enc, dbytes) \
                        in in_edges.get(st, []):
                    dep = done.get((src, mb))
                    if dep is None:
                        continue
                    # Codec span: the fused encode runs on the source
                    # device's serial codec stream, *double-buffered*
                    # against that device's next micro-batch compute — it
                    # delays when the payload reaches the link, but never
                    # pushes device_free.
                    if t_enc > 0.0:
                        src_dev = stages[src]
                        e_start = max(dep, enc_free.get(src_dev, t0))
                        dep = e_start + t_enc
                        enc_free[src_dev] = dep
                        enc_total += t_enc
                        if record_kernel is not None:
                            record_kernel(KernelTiming(
                                node=src_dev, nbytes=dbytes, seconds=t_enc,
                                backward=backward, step=step))
                        if tracer is not None:
                            tracer.span(
                                CAT_ENCODE, f"{tag}enc.mb{mb}",
                                f"codec{src_dev}", e_start, dep,
                                args={"dense_bytes": dbytes, "mb": mb})
                    lk = (src, st)
                    start = max(dep, link_free.get(lk, t0))
                    link_free[lk] = start + tcomm
                    comm_total += tcomm
                    comm_charged[(charge, mb)] = \
                        comm_charged.get((charge, mb), 0.0) + tcomm
                    if record_link is not None:
                        record_link(LinkTiming(
                            src=stages[src], dst=stages[st], nbytes=ebytes,
                            seconds=tcomm, backward=backward, step=step))
                    if tracer is not None:
                        tracer.span(
                            CAT_TRANSFER, f"{tag}xfer.mb{mb}",
                            f"link {stages[src]}->{stages[st]}",
                            start, start + tcomm,
                            args={"nbytes": ebytes, "mb": mb,
                                  "charge": stages[charge]})
                    ready = max(ready, start + tcomm)
                start = max(ready, device_free.get(dev, t0))
                end = start + comp[st]
                device_free[dev] = end
                busy[dev] = busy.get(dev, 0.0) + comp[st]
                done[(st, mb)] = end
                if tracer is not None:
                    tracer.span(cat, f"{tag}{st}.mb{mb}", f"dev{dev}",
                                start, end, args={"stage": st, "mb": mb})
                events.append((start, end,
                               f"{'B' if backward else 'F'}{st}.mb{mb}"))
        if telemetry is not None:
            for st in range(k):
                for mb in range(n_micro):
                    telemetry.record(StepTiming(
                        node=stages[st], stage=st, micro_batch=mb,
                        backward=backward, compute_seconds=comp[st],
                        comm_seconds=comm_charged.get((st, mb), 0.0),
                        step=step))
        finish = max(done.values()) if done else t0
        return finish, comm_total, nbytes * n_micro, enc_total

    events: List[Tuple[float, float, str]] = []
    device_free: Dict[int, float] = {}
    busy: Dict[int, float] = {}
    enc_free: Dict[int, float] = {}
    t_fwd, comm_f, bytes_f, enc_f = run_pass(False, 0.0, events, device_free,
                                             busy, enc_free)
    t_end, comm_b, bytes_b, enc_b = run_pass(True, t_fwd, events, device_free,
                                             busy, enc_free)
    n_dev = len(cluster)
    return SimResult(
        iteration_time=t_end, fwd_time=t_fwd, bwd_time=t_end - t_fwd,
        device_busy=[busy.get(d, 0.0) for d in range(n_dev)],
        link_busy=comm_f + comm_b, comm_bytes=bytes_f + bytes_b,
        events=sorted(events), compress_busy=enc_f + enc_b)
