"""The port's elastic runtime against the JAX package's, on the CPU.

Membership, detection, re-planning, migration planning, the simulated
clock, telemetry windows and calibration are framework-free, so every
scenario below runs through both packages on the same graph, cluster, trace
and seeds and its summary (epoch records, step records, schedules, moves,
migrated bytes, clock) must be EQUAL.  Each scenario also holds the port
to the claims the JAX package's own test of it makes
(``tests/test_elastic.py``, ``test_closed_loop.py``, ``test_telemetry.py``,
``test_kernel_pricing.py``).

Training through churn is in ``test_torch_elastic_training.py``.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as j_core  # noqa: E402
import repro.elastic as j_el  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.elastic as t_el  # noqa: E402
from helpers import mlp_chain as j_mlp_chain  # noqa: E402
from repro.core.opgraph import chain as j_chain  # noqa: E402
from repro.optim import optimizers as j_optim  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree  # noqa: E402
from repro_torch.core.opgraph import OpGraph, OpNode, OpType  # noqa: E402
from repro_torch.core.opgraph import chain as t_chain  # noqa: E402
from repro_torch.optim import optimizers as t_optim  # noqa: E402

CPU = torch.device("cpu")


# ----------------------------------------------------------- the port's MLP
def _linear_node(name, arg, din, dout):
    def init(gen, in_shape):
        return {"w": torch.randn(din, dout, generator=gen,
                                 device=gen.device) * (din ** -0.5),
                "b": torch.zeros(dout, device=gen.device)}

    def apply(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    return OpNode(name=name, op_type=OpType.PARAMETRIC, args=(arg,),
                  init_fn=init, apply_fn=apply,
                  out_shape_fn=lambda s: (s[0], dout),
                  flops_fn=lambda s: 2.0 * s[0] * din * dout,
                  n_params_fn=lambda s: din * dout + dout)


def t_mlp_chain(n_layers=6, d=16, batch=4, seed=0):
    """``tests/helpers.mlp_chain`` in the port: the same OP-DAG, with the
    JAX helper's weights and inputs carried across."""
    g = OpGraph("mlp")
    g.add(OpNode("x", OpType.PLACEHOLDER))
    prev = "x"
    for i in range(n_layers):
        g.add(_linear_node(f"l{i}", prev, d, d))
        prev = f"l{i}"
    g.add(OpNode("y", OpType.PLACEHOLDER))
    g.add(OpNode("loss", OpType.LOSS, args=(prev, "y"),
                 apply_fn=lambda p, a, b: torch.mean((a - b) ** 2),
                 out_shape_fn=lambda *s: (),
                 flops_fn=lambda *s: float(np.prod(s[0]))))
    _, shapes, params, inputs = j_mlp_chain(n_layers, d, batch, seed)
    return (g, shapes, from_numpy_tree(_np(params), CPU),
            from_numpy_tree(_np(inputs), CPU))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _side(core, el, replan_mod, chain, mlp, optim, controller_kw):
    ns = types.SimpleNamespace(**{k: getattr(core, k) for k in dir(core)
                                  if not k.startswith("_")})
    for k in dir(el):
        if not k.startswith("_"):
            setattr(ns, k, getattr(el, k))
    ns.replan_mod, ns.chain, ns.mlp_chain, ns.optim = \
        replan_mod, chain, mlp, optim
    ns.EC = lambda *a, **kw: el.ElasticController(*a, **kw, **controller_kw)
    return ns


# the packages' ``replan`` attribute is the function, not the module
j_replan = sys.modules["repro.elastic.replan"]
t_replan = sys.modules["repro_torch.elastic.replan"]
J = _side(j_core, j_el, j_replan, j_chain, j_mlp_chain, j_optim, {})
T = _side(t_core, t_el, t_replan, t_chain, t_mlp_chain, t_optim,
          {"device": "cpu"})


# --------------------------------------------------------------- summaries
def _asdict(x):
    return dataclasses.asdict(x)


def _sched(s):
    return (s.assignment, s.stages, s.clusters, s.predicted_pace)


def _rp(rp):
    return _asdict(rp)


def _run(res, with_loss=False):
    steps = [_asdict(s) for s in res.steps]
    if not with_loss:
        for s in steps:
            s.pop("loss")
    return ([_asdict(e) for e in res.epochs], steps, res.total_seconds)


def _order_ok(g, m, schedule):
    order = {op: i for i, op in enumerate(m.chain(g))}
    for seg in schedule.assignment:
        idx = sorted(order[op] for op in seg if op in order)
        if idx:
            assert idx == list(range(idx[0], idx[0] + len(idx)))


def _mlp_setup(m, n_layers=10, n_dev=6, seed=3):
    g, shapes, params, inputs = m.mlp_chain(n_layers=n_layers, d=16, batch=4)
    prof = g.annotate(shapes)
    cluster = m.network.geo_random(n=n_dev, n_sites=2, seed=seed)
    return g, prof, cluster, params, inputs


def _probe(m, g, prof, cluster, **kw):
    probe = m.EC(g, prof, cluster, m.ChurnTrace(()), n_micro=2, **kw)
    return probe, probe.run(steps=1).steps[0].step_seconds


# ------------------------------------------------- membership and detector
def sc_trace_json_and_membership(m):
    trace = m.ChurnTrace.build([
        {"t": 9.0, "kind": "leave", "node": 2},
        {"t": 1.0, "kind": "slowdown", "node": 0, "factor": 0.25},
        {"t": 4.0, "kind": "join", "node": 5},
        {"t": 5.0, "kind": "slowlink", "node": 1, "factor": 0.5},
        {"t": 7.0, "kind": "recover", "node": 1},
    ])
    assert m.ChurnTrace.from_json(trace.to_json()) == trace
    out = [trace.to_json(), [e.time for e in trace.between(1.0, 9.0)]]
    view = m.MembershipView(8, trace, lease_s=1.5)
    for t in (0.5, 1.5, 4.1, 5.5, 6.6, 9.9, 10.6, 12.0):
        deltas = view.poll(t)
        out.append((view.snapshot(), [(_asdict(d.event), d.detected_at)
                                      for d in deltas]))
    assert view.alive == [0, 1, 3, 4, 5, 6, 7] and view.epoch == 1
    with pytest.raises(ValueError):
        m.ChurnEvent(time=0.0, kind="slowlink", node=0, factor=1.5)
    return out


def sc_detector(m):
    det = m.StragglerDetector({0: 1.0, 1: 2.0}, alpha=0.5, threshold=1.8,
                              min_observations=3)
    out = []
    for i in range(5):
        det.observe({0: 1.05, 1: 8.0 + i})
        out.append((det.flagged(), det.severity(0), det.severity(1),
                    det.believed_factors()))
    det.reprice({0: 0.5, 1: 4.0, 2: 1.0})
    out.append((det.flagged(), det.severity(1), det.believed_factors()))
    assert out[-1][0] == [0, 1]
    det.reset({0: 1.0})
    out.append((det.flagged(), det.severity(0)))
    return out


# ----------------------------------------------------------------- replan --
def sc_replan_after_node_loss(m):
    g, prof, cluster, _, _ = _mlp_setup(m)
    old = m.schedule_opfence(g, prof, cluster)
    victim = old.stage_devices()[1]
    alive = [d for d in range(len(cluster)) if d != victim]
    rp = m.replan(g, prof, cluster, old, alive=alive, dead=[victim])
    assert rp.schedule.assignment[victim] == []
    assert sorted(op for seg in rp.schedule.assignment for op in seg) == \
        sorted(g.nodes)
    _order_ok(g, m, rp.schedule)
    rp.schedule.pipeline_subdags(g)
    assert any(mv.from_checkpoint for mv in rp.migration.moves)
    assert rp.migration.seconds > 0.0
    noop = m.replan(g, prof, cluster, old, alive=list(range(len(cluster))))
    assert noop.migration.moves == [] and noop.migration.seconds == 0.0
    return [_sched(old), _rp(rp), _rp(noop)]


def sc_replan_modes(m):
    g, prof, cluster, _, _ = _mlp_setup(m, n_layers=16, n_dev=8)
    old = m.schedule_opfence(g, prof, cluster)
    victim = old.stage_devices()[2]
    alive = [d for d in range(len(cluster)) if d != victim]
    out = {mode: m.replan(g, prof, cluster, old, alive=alive, dead=[victim],
                          mode=mode) for mode in ("full", "anchored", "auto")}
    assert out["anchored"].migration.total_bytes <= \
        out["full"].migration.total_bytes
    assert out["anchored"].schedule.stage_devices() == \
        [d for d in old.stage_devices() if d != victim]
    return {k: _rp(v) for k, v in out.items()}


def sc_pinned_replan_zero_wan(m):
    g, shapes, _, _ = m.mlp_chain(n_layers=16, d=64, batch=8)
    prof = g.annotate(shapes)
    cluster = m.network.paper_testbed(1, seed=0)
    old = m.schedule_opfence(g, prof, cluster)
    victim = old.stage_devices()[2]
    alive = [d for d in range(len(cluster)) if d != victim]
    comms = m.replan_mod._communities_for(cluster, old)
    unpinned = m.replan(g, prof, cluster, old, alive=alive, dead=[victim],
                        mode="anchored")
    pinned = m.replan(g, prof, cluster, old, alive=alive, dead=[victim],
                      mode="anchored", pin_boundaries=True)
    wan = (m.cross_cluster_bytes(unpinned.migration.moves, comms),
           m.cross_cluster_bytes(pinned.migration.moves, comms))
    assert wan[0] > 0 and wan[1] == 0.0
    _order_ok(g, m, pinned.schedule)
    return [comms, wan, _rp(unpinned), _rp(pinned)]


def sc_pinned_joiners_and_fallback(m):
    g, shapes, _, _ = m.mlp_chain(n_layers=24, d=64, batch=8)
    prof = g.annotate(shapes)
    cluster = m.network.paper_testbed(1, seed=0)
    out = []
    subset = [d for d in range(len(cluster)) if d not in (8, 9, 10, 11)]
    old = m.schedule_opfence(g, prof, cluster, device_subset=subset)
    comms = m.replan_mod._communities_for(cluster, old)
    rp = m.replan(g, prof, cluster, old, alive=list(range(len(cluster))),
                  joined=[8], mode="anchored", pin_boundaries=True)
    assert rp.schedule.assignment[8] == []      # unknown community: deferred
    out += [comms, _rp(rp)]
    subset = [d for d in range(len(cluster)) if d not in (8, 9)]
    old = m.schedule_opfence(g, prof, cluster, device_subset=subset)
    comms = m.replan_mod._communities_for(cluster, old)
    ext = m.replan_mod._extend_communities(cluster, comms, [8])
    rp = m.replan(g, prof, cluster, old, alive=subset + [8], joined=[8],
                  mode="anchored", pin_boundaries=True)
    assert rp.schedule.assignment[8]            # mapped into its site
    assert m.cross_cluster_bytes(rp.migration.moves, ext) == 0.0
    out += [ext, _rp(rp)]
    g, shapes, _, _ = m.mlp_chain(n_layers=16, d=64, batch=8)
    prof = g.annotate(shapes)
    full = m.schedule_opfence(g, prof, cluster)
    devs = full.stage_devices()
    spares = [d for d in range(len(cluster)) if d not in set(devs)]
    rp = m.replan(g, prof, cluster, full, alive=spares, dead=list(devs),
                  mode="auto", pin_boundaries=True)
    assert rp.mode == "full"
    assert all(mv.src is None for mv in rp.migration.moves)
    return out + [_rp(rp)]


def sc_interim_schedule(m):
    g, prof, cluster, _, _ = _mlp_setup(m, n_layers=12)
    old = m.schedule_opfence(g, prof, cluster)
    devs = old.stage_devices()
    interim = m.interim_schedule(g, old, [devs[2]], len(cluster))
    assert interim.assignment[devs[2]] == []
    assert interim.stage_devices() == [d for d in devs if d != devs[2]]
    _order_ok(g, m, interim)
    interim0 = m.interim_schedule(g, old, [devs[0]], len(cluster))
    assert m.interim_schedule(g, old, list(devs), len(cluster)) is None
    return [_sched(interim), _sched(interim0),
            [_asdict(mv) for mv in m.diff_schedules(old, interim, prof,
                                                    dead=[devs[2]])]]


def sc_simulate_migration(m):
    cluster = m.network.homogeneous_lan(n=4, bandwidth_Bps=1e9, alpha=0.0)
    geo = m.network.paper_testbed(1, seed=0)
    sims = [m.simulate_migration({(0, 1): 1e9}, cluster),
            m.simulate_migration({(0, 1): 1e9, (0, 2): 1e9}, cluster),
            m.simulate_migration({(0, 1): 1e9, (2, 3): 1e9}, cluster),
            m.simulate_migration({(None, 3): 5e8, (1, 3): 2e8, (4, 9): 3e8,
                                  (None, 2): 1e8}, geo,
                                 bandwidth_fraction=0.25)]
    assert sims[1].seconds == pytest.approx(2 * sims[0].seconds, rel=1e-6)
    assert sims[2].seconds == pytest.approx(sims[0].seconds, rel=1e-6)
    return [_asdict(s) for s in sims] + [m.executor.CHECKPOINT_LINK.alpha,
                                         m.executor.CHECKPOINT_LINK.beta]


def sc_predict_step_times(m):
    g, prof, cluster, _, _ = _mlp_setup(m)
    sched = m.schedule_opfence(g, prof, cluster)
    base = m.predict_step_times(g, prof, cluster, sched.placement)
    slow = m.predict_step_times(
        g, prof, m.network.with_slowdowns(cluster, {0: 0.25}),
        sched.placement)
    return [base, slow]


# ------------------------------------------------------------- controller --
def sc_controller_determinism(m):
    g, prof, cluster, _, _ = _mlp_setup(m)
    probe, t1 = _probe(m, g, prof, cluster)
    dev = probe.schedule.stage_devices()
    trace = m.ChurnTrace((
        m.ChurnEvent(time=1.2 * t1, kind="slowdown", node=dev[0], factor=0.2),
        m.ChurnEvent(time=6.0 * t1, kind="leave", node=dev[1]),
    ))
    runs = [_run(m.EC(g, prof, cluster, trace, n_micro=2,
                      lease_s=t1).run(steps=25)) for _ in range(2)]
    assert runs[0] == runs[1]
    assert len(runs[0][0]) >= 3         # initial + straggler + failure
    return runs[0]


def sc_controller_charges_churn_costs(m):
    g, prof, cluster, _, _ = _mlp_setup(m)
    probe, t1 = _probe(m, g, prof, cluster)
    victim = probe.schedule.stage_devices()[1]
    ctrl = m.EC(g, prof, cluster, m.single_failure_trace(victim, at=2.5 * t1),
                n_micro=2, lease_s=t1)
    res = ctrl.run(steps=10)
    fail = [e for e in res.epochs if e.cause == "failure"]
    assert len(fail) == 1
    e = fail[0]
    assert e.migrate_seconds > 0 and e.refill_seconds > 0
    assert e.detect_seconds >= t1 and e.rollback_steps >= 1
    assert res.total_seconds > sum(s.step_seconds for s in res.steps
                                   if not s.lost)
    return [_run(res), res.useful_steps, res.samples_per_second(4),
            res.post_failure_throughput(4)]


def sc_straggler_cycle(m, mode):
    g, prof, cluster, _, _ = _mlp_setup(m, n_layers=8)
    probe, t1 = _probe(m, g, prof, cluster)
    victim = probe.schedule.stage_devices()[0]
    trace = m.ChurnTrace((
        m.ChurnEvent(time=1.5 * t1, kind="slowdown", node=victim, factor=0.4),
        m.ChurnEvent(time=25 * t1, kind="recover", node=victim),
    ))
    ctrl = m.EC(g, prof, cluster, trace, n_micro=2, migration_mode=mode)
    res = ctrl.run(steps=60)
    causes = [e.cause for e in res.epochs]
    assert "straggler" in causes and "recovery" in causes
    assert ctrl.believed_factors == {}
    return _run(res)


def sc_join(m):
    g, prof, cluster, _, _ = _mlp_setup(m, n_layers=12)
    alive0 = [0, 1, 2, 3]
    _, t1 = _probe(m, g, prof, cluster, initial_alive=alive0)
    trace = m.ChurnTrace((m.ChurnEvent(time=2.5 * t1, kind="join", node=4),))
    res = m.EC(g, prof, cluster, trace, n_micro=2,
               initial_alive=alive0).run(steps=8)
    joins = [e for e in res.epochs if e.cause == "join"]
    assert len(joins) == 1 and 4 in joins[0].alive
    assert joins[0].rollback_steps == 0
    return _run(res)


def sc_detector_consumes_telemetry(m):
    g, prof, cluster, _, _ = _mlp_setup(m)
    ctrl = m.EC(g, prof, cluster, m.ChurnTrace(()), n_micro=2)
    ctrl.run(steps=4)
    assert ctrl.telemetry.n_samples > 0
    agg = ctrl.telemetry.node_step_times()
    for d, st in ctrl.detector.stats.items():
        if st.ewma is not None and d in agg:
            assert st.ewma == pytest.approx(agg[d], rel=1e-9, abs=1e-15)
    return [agg, {d: (st.ewma, st.count, st.predicted)
                  for d, st in ctrl.detector.stats.items()},
            ctrl.telemetry.n_samples]


def sc_pinned_controller_failover(m):
    g, shapes, _, _ = m.mlp_chain(n_layers=16, d=32, batch=4)
    prof = g.annotate(shapes)
    cluster = m.network.paper_testbed(1, seed=0)
    probe, t1 = _probe(m, g, prof, cluster)
    victim = probe.schedule.stage_devices()[2]
    ctrl = m.EC(g, prof, cluster, m.single_failure_trace(victim, at=2.5 * t1),
                n_micro=2, lease_s=t1, replan_mode="anchored",
                pin_boundaries=True)
    res = ctrl.run(steps=10)
    assert any(e.cause == "failure" for e in res.epochs)
    assert ctrl.schedule.assignment[victim] == []
    return _run(res)


def _compute_bound_lan(m, n_layers=12, d=512, lam=1e-6):
    g, shapes, _, _ = m.mlp_chain(n_layers=n_layers, d=d, batch=4)
    prof = g.annotate(shapes)
    cluster = m.network.with_slowdowns(
        m.network.homogeneous_lan(n=6, bandwidth_Bps=12.5e6, alpha=1e-4),
        {i: lam for i in range(6)})
    return g, prof, cluster


def sc_overlap_streams_then_cuts_over(m):
    g, prof, cluster = _compute_bound_lan(m)
    probe, t1 = _probe(m, g, prof, cluster)
    victim = probe.schedule.stage_devices()[1]
    ctrl = m.EC(g, prof, cluster, m.single_failure_trace(victim, at=2.5 * t1),
                n_micro=2, lease_s=t1, migration_mode="overlap")
    res = ctrl.run(steps=30)
    causes = [e.cause for e in res.epochs]
    fail = res.epochs[causes.index("failure")]
    assert fail.replan_mode == "interim" and fail.rollback_steps >= 1
    assert fail.migrate_seconds > 0 and fail.refill_seconds > 0
    cut = res.epochs[causes.index("cutover")]
    assert cut.background_bytes > 0 and cut.overlap_seconds > 0
    assert cut.refill_seconds == 0.0
    assert any(s.overlapping for s in res.steps)
    return _run(res)


def sc_overlap_keeps_interim(m):
    g, shapes, _, _ = m.mlp_chain(n_layers=10, d=64, batch=4)
    prof = g.annotate(shapes)
    cluster = m.network.geo_random(n=6, n_sites=2, seed=3)
    probe, t1 = _probe(m, g, prof, cluster)
    victim = probe.schedule.stage_devices()[1]
    res = m.EC(g, prof, cluster, m.single_failure_trace(victim, at=2.5 * t1),
               n_micro=2, lease_s=t1, migration_mode="overlap").run(steps=20)
    causes = [e.cause for e in res.epochs]
    assert res.epochs[causes.index("failure")].replan_mode == "interim-final"
    assert "cutover" not in causes
    return _run(res)


def sc_overlap_beats_stop(m):
    g, shapes, _, _ = m.mlp_chain(n_layers=12, d=128, batch=4)
    prof = g.annotate(shapes)
    cluster = m.network.homogeneous_lan(n=6, bandwidth_Bps=12.5e6, alpha=1e-4)
    probe, t1 = _probe(m, g, prof, cluster)
    victim = probe.schedule.stage_devices()[1]
    res = {mode: m.EC(g, prof, cluster,
                      m.single_failure_trace(victim, at=2.5 * t1), n_micro=2,
                      lease_s=t1, migration_mode=mode,
                      opt_state_mult=20.0).run(steps=30)
           for mode in ("stop", "overlap")}
    assert res["overlap"].useful_steps == res["stop"].useful_steps
    assert res["overlap"].post_failure_throughput(1) > \
        res["stop"].post_failure_throughput(1)
    return {k: _run(v) for k, v in res.items()}


# ------------------------------------------------- closed planning loop ----
def _fat_pipe(m, n_layers=12):
    g, shapes, _, _ = m.mlp_chain(n_layers=n_layers, d=512, batch=8)
    prof = g.annotate(shapes)
    return g, prof, m.network.fat_pipe_sites(n=8, n_sites=2, seed=0)


def _fat_pipe_victim(m, probe, cluster):
    devs = probe.schedule.stage_devices()
    wan_bw = min(cluster.link(a, b).bandwidth for a, b in zip(devs, devs[1:]))
    adjacent = {d: [] for d in devs}
    for a, b in zip(devs, devs[1:]):
        adjacent[a].append((a, b))
        adjacent[b].append((a, b))
    eligible = [d for d in devs if adjacent[d] and all(
        cluster.link(*p).bandwidth > 10.0 * wan_bw for p in adjacent[d])]
    model = m.EdgeCostModel(probe.graph, probe.profiles, cluster, probe.plan)
    placement = probe.schedule.placement
    weight = {d: 0.0 for d in devs}
    for (a, n) in model.cross_edges(placement):
        pair = (placement[a], placement[n])
        for d in pair:
            if pair in adjacent.get(d, []):
                weight[d] += model.edge_seconds(a, n, *pair)
    return max(eligible, key=lambda d: weight[d])


def sc_closed_loop_calibration(m):
    g, prof, cluster = _fat_pipe(m)
    common = dict(n_micro=2, planner="joint", joint_ratio=64.0,
                  detector_threshold=20.0, calibrate_min_samples=3,
                  replan_pace_margin=0.2)
    probe, t1 = _probe(m, g, prof, cluster, calibrate_interval=0,
                       **{k: v for k, v in common.items() if k != "n_micro"})
    victim = _fat_pipe_victim(m, probe, cluster)
    trace = m.ChurnTrace((m.ChurnEvent(time=4.0 * t1, kind="slowlink",
                                       node=victim, factor=0.5),))
    out = {}
    for name, interval in (("cal", 3), ("static", 0)):
        ctrl = m.EC(g, prof, cluster, trace, calibrate_interval=interval,
                    **common)
        out[name] = [_run(ctrl.run(steps=30)), ctrl.link_corrections,
                     ctrl.calibration_count,
                     {d: kc.bytes_per_second
                      for d, kc in ctrl.kernel_cost_belief.items()}]
    assert out["cal"][1] and all(c == pytest.approx(2.0, rel=0.15)
                                 for c in out["cal"][1].values())
    assert "calibration" in [e["cause"] for e in out["cal"][0][0]]
    assert out["static"][1] == {}
    return out


def sc_hysteresis_zero_replans(m):
    g, prof, cluster = _fat_pipe(m)
    ctrl = m.EC(g, prof, cluster, m.ChurnTrace(()), n_micro=2,
                calibrate_interval=3, calibrate_min_samples=3)
    ctrl.run(steps=12)
    rng = np.random.default_rng(7)
    devs = ctrl.schedule.stage_devices()
    fired = []
    for step in range(12, 60):
        for (a, b) in zip(devs, devs[1:]):
            ctrl.telemetry.record_link(m.LinkTiming(
                src=a, dst=b, nbytes=1e5,
                seconds=cluster.comm_time(a, b, 1e5)
                * float(rng.uniform(0.9, 1.1)), step=step))
        if step % 3 == 0:
            fired.append(bool(ctrl._calibrate()))
    assert not any(fired) and ctrl.link_corrections == {}
    return [fired, ctrl.calibration_count,
            [_asdict(e) for e in ctrl.epoch_records]]


def sc_joint_planner_and_replan(m):
    g, prof, cluster = _fat_pipe(m)
    ctrl = m.EC(g, prof, cluster, m.ChurnTrace(()), n_micro=2,
                planner="joint", joint_ratio=32.0)
    jp = m.schedule_joint(g, prof, cluster, ratio=32.0)
    assert ctrl.schedule.assignment == jp.schedule.assignment
    assert ctrl.plan.edge_ratio
    old = m.schedule_opfence(g, prof, cluster)
    alive = list(range(len(cluster)))
    victim = old.stage_devices()[1]
    surv = [d for d in alive if d != victim]
    rp = m.replan(g, prof, cluster, old, alive=surv, dead=[victim],
                  mode="full", planner="joint", joint_ratio=32.0)
    direct = m.schedule_joint(g, prof, cluster, ratio=32.0,
                              device_subset=surv)
    assert rp.schedule.assignment == direct.schedule.assignment
    keep = m.replan(g, prof, cluster, old, alive=alive, opt_state_mult=1e6,
                    cost_model=m.EdgeCostModel(g, prof, cluster))
    assert keep.mode in ("keep", "anchored") and keep.migration.moves == []
    with pytest.raises(ValueError):
        m.EC(g, prof, cluster, m.ChurnTrace(()), planner="bogus")
    with pytest.raises(ValueError):
        m.replan(g, prof, cluster, old, alive=alive, planner="bogus")
    pins = [m.EC(g, prof, cluster, m.ChurnTrace(()), **kw).pin_boundaries
            for kw in ({}, {"migration_mode": "overlap"},
                       {"migration_mode": "overlap", "pin_boundaries": False})]
    assert pins == [False, True, False]
    return [_sched(ctrl.schedule), ctrl.plan.edge_ratio, _sched(jp.schedule),
            jp.plan.edge_ratio, jp.predicted_pace, jp.iterations,
            jp.converged, _rp(rp), _rp(keep),
            m.SCHEDULERS["joint"](g, prof, cluster, ratio=32.0).assignment]


# --------------------------------------------------------------- telemetry -
def sc_telemetry_windows(m):
    g, prof, cluster = _fat_pipe(m)
    sch = m.schedule_opfence(g, prof, cluster)
    sink = m.TelemetrySink()
    m.simulate_iteration(g, prof, sch, cluster, n_micro=2, telemetry=sink)
    log = m.TelemetryLog(window=5, mad_k=3.5)
    for step in range(6):
        scale = 9.0 if step == 2 else 1.0 + 0.01 * step
        log.record_step([dataclasses.replace(
            s, compute_seconds=s.compute_seconds * scale)
            for s in sink.samples], step=step)
        log.record_link_step([dataclasses.replace(s, seconds=s.seconds
                                                  * scale)
                              for s in sink.link_samples], step=step)
    out = [[_asdict(s) for s in sink.samples],
           [_asdict(s) for s in sink.link_samples], log.n_samples,
           log.node_step_times(), log.link_samples(min_steps=3),
           m.fit_link_corrections(log.link_samples(min_steps=3), cluster)]
    log.clear()
    assert log.node_step_times() == {}
    return out


def sc_kernel_pricing(m):
    g, prof, cluster = _fat_pipe(m)
    sch = m.schedule_opfence(g, prof, cluster)
    plan = m.plan_adatopk(g, prof, cluster, sch.placement, 32.0)
    costs = {d: m.costmodel.KernelCostModel(alpha=1e-4, bytes_per_second=2e8)
             for d in range(len(cluster))}
    model = m.EdgeCostModel(g, prof, cluster, plan, kernel_costs=costs)
    sink = m.TelemetrySink()
    sim = m.simulate_iteration(g, prof, sch, cluster, plan, n_micro=2,
                               telemetry=sink, cost_model=model)
    log = m.TelemetryLog(window=5)
    for step in range(4):
        log.record_kernel_step(sink.kernel_samples, step=step)
    fitted = m.costmodel.fit_kernel_costs(log.kernel_samples(min_steps=3))
    ctrl = m.EC(g, prof, cluster, m.ChurnTrace(()), n_micro=2,
                planner="joint", joint_ratio=32.0, kernel_costs=costs,
                calibrate_interval=3)
    res = ctrl.run(steps=9)
    assert ctrl.kernel_cost_belief
    return [sim.iteration_time, sim.compress_busy,
            [_asdict(s) for s in sink.kernel_samples],
            {d: (k.alpha, k.bytes_per_second) for d, k in fitted.items()},
            model.stage_pace(sch), _run(res),
            {d: (k.alpha, k.bytes_per_second)
             for d, k in ctrl.kernel_cost_belief.items()}]


SCENARIOS = {
    "trace_json_and_membership": sc_trace_json_and_membership,
    "detector": sc_detector,
    "replan_after_node_loss": sc_replan_after_node_loss,
    "replan_modes": sc_replan_modes,
    "pinned_replan_zero_wan": sc_pinned_replan_zero_wan,
    "pinned_joiners_and_fallback": sc_pinned_joiners_and_fallback,
    "interim_schedule": sc_interim_schedule,
    "simulate_migration": sc_simulate_migration,
    "predict_step_times": sc_predict_step_times,
    "controller_determinism": sc_controller_determinism,
    "controller_charges_churn_costs": sc_controller_charges_churn_costs,
    "straggler_cycle_stop": lambda m: sc_straggler_cycle(m, "stop"),
    "straggler_cycle_overlap": lambda m: sc_straggler_cycle(m, "overlap"),
    "join": sc_join,
    "detector_consumes_telemetry": sc_detector_consumes_telemetry,
    "pinned_controller_failover": sc_pinned_controller_failover,
    "overlap_streams_then_cuts_over": sc_overlap_streams_then_cuts_over,
    "overlap_keeps_interim": sc_overlap_keeps_interim,
    "overlap_beats_stop": sc_overlap_beats_stop,
    "closed_loop_calibration": sc_closed_loop_calibration,
    "hysteresis_zero_replans": sc_hysteresis_zero_replans,
    "joint_planner_and_replan": sc_joint_planner_and_replan,
    "telemetry_windows": sc_telemetry_windows,
    "kernel_pricing": sc_kernel_pricing,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name):
    assert SCENARIOS[name](T) == SCENARIOS[name](J)


# ------------------------------------------------------------- migration --
@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_migration_roundtrip_is_bitexact_and_matches_jax(opt):
    out = {}
    for name, m in (("jax", J), ("torch", T)):
        g, prof, cluster, params, _ = _mlp_setup(m)
        o = (m.optim.adamw(lr=1e-3) if opt == "adamw"
             else m.optim.sgd(lr=1e-2, momentum=0.9))
        st = o.init(params)
        grads = jax.tree_util.tree_map(jax.numpy.ones_like, params) \
            if m is J else t_core.rad.tree_map(torch.ones_like, params)
        params, st = o.update(grads, st, params)
        old = m.schedule_opfence(g, prof, cluster)
        alive = [d for d in range(len(cluster))
                 if d != old.stage_devices()[0]]
        new = m.schedule_opfence(g, prof, cluster, device_subset=alive)
        moves = m.diff_schedules(old, new, prof)
        assert moves
        res = m.apply_moves(params, st, moves)
        assert res.wire_bytes > 0
        assert m.trees_bitexact(params, res.params)
        assert m.trees_bitexact(st, res.opt_state)
        out[name] = (res, [_asdict(mv) for mv in moves])
    (jr, jm), (tr, tm) = out["jax"], out["torch"]
    assert tm == jm
    assert (tr.wire_bytes, tr.n_envelopes) == (jr.wire_bytes, jr.n_envelopes)
    assert t_el.trees_bitexact(from_numpy_tree(_np(jr.params), CPU),
                               tr.params)


def test_trees_bitexact_matches_numpy_array_equal():
    """``trees_bitexact`` is ``np.array_equal(..., equal_nan=True)`` leaf by
    leaf with dtype, shape and structure checks: NaN equals NaN (any
    payload), -0.0 equals 0.0, one flipped bit is a difference."""
    a = torch.tensor([1.0, float("nan"), 0.0, -2.5])
    nan2 = torch.tensor([0x7FC00001], dtype=torch.int32).view(torch.float32)
    cases = [
        (a, a.clone(), True),
        (a, torch.tensor([1.0, nan2.item(), -0.0, -2.5]), True),
        (a, (a.view(torch.int32) ^ 1).view(torch.float32), False),
        (a, a.to(torch.float64), False),
        (a, a.reshape(2, 2), False),
        (a.to(torch.bfloat16), a.to(torch.bfloat16).clone(), True),
        (torch.arange(4), torch.arange(4), True),
    ]
    for x, y, want in cases:
        xn, yn = x.float().numpy(), y.float().numpy()
        if x.dtype == y.dtype and x.shape == y.shape:
            assert np.array_equal(xn, yn, equal_nan=True) == want
        assert t_el.trees_bitexact({"p": {"w": x}}, {"p": {"w": y}}) == want
    opt = t_optim.OptState(step=torch.zeros((), dtype=torch.int32),
                           inner={"m": {"w": a}})
    assert t_el.trees_bitexact(opt, opt)
    assert not t_el.trees_bitexact(opt, opt._replace(inner={"m": {"v": a}}))
    assert not t_el.trees_bitexact(opt, (opt.step, opt.inner))
    assert not t_el.trees_bitexact({"w": a}, {"w": a, "b": a})
