"""The port's planner and simulator against the JAX package's, exactly.

OP-Fence placements and stages, AdaTopK/uniform ratios and the simulated
iteration are framework-free arithmetic over shapes, so they are compared
for equality on gpt2-xl at its full width and depth, on paper testbeds 1
and 2 (profiling reads shapes only, so this is cheap on the CPU)."""
import pytest

pytest.importorskip("torch")

from repro.configs import resolve as j_resolve  # noqa: E402
from repro.core import (network as j_net, plan_adatopk as j_adatopk,  # noqa: E402
                        plan_uniform as j_uniform,
                        schedule_opfence as j_opfence,
                        simulate_iteration as j_sim)
from repro.models.opgraph_models import gpt_opgraph as j_gpt  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core import (network as t_net, plan_adatopk as t_adatopk,  # noqa: E402
                              plan_uniform as t_uniform,
                              schedule_opfence as t_opfence,
                              simulate_iteration as t_sim)
from repro_torch.models.opgraph_models import gpt_opgraph as t_gpt  # noqa: E402

BATCH, SEQ = 8, 128
SHAPES = {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ)}


def _plan(side, testbed):
    resolve, gpt, net, opfence, uniform, adatopk, sim = side
    cfg = resolve("gpt2-xl").full
    graph = gpt(cfg, BATCH, SEQ)
    prof = graph.annotate(SHAPES)
    cluster = net.paper_testbed(testbed, seed=0)
    sch = opfence(graph, prof, cluster)
    plans = {"uniform": uniform(graph, sch.placement, 100.0),
             "adatopk": adatopk(graph, prof, cluster, sch.placement, 100.0)}
    sims = {name: sim(graph, prof, sch, cluster, p, n_micro=2)
            for name, p in plans.items()}
    return cfg, prof, sch, plans, sims


JAX = (j_resolve, j_gpt, j_net, j_opfence, j_uniform, j_adatopk, j_sim)
TORCH = (t_resolve, t_gpt, t_net, t_opfence, t_uniform, t_adatopk, t_sim)


@pytest.mark.parametrize("testbed", [1, 2])
def test_gpt2_xl_full_plans_equal_jax(testbed):
    jcfg, jprof, jsch, jplans, jsims = _plan(JAX, testbed)
    tcfg, tprof, tsch, tplans, tsims = _plan(TORCH, testbed)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.vocab_padded) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.vocab_padded) == (48, 1600, 50432)
    assert {n: (p.out_shape, p.fwd_flops, p.out_bytes, p.n_params)
            for n, p in tprof.items()} == \
        {n: (p.out_shape, p.fwd_flops, p.out_bytes, p.n_params)
         for n, p in jprof.items()}
    assert tsch.assignment == jsch.assignment
    assert tsch.stages == jsch.stages
    assert tsch.placement == jsch.placement
    assert tsch.predicted_pace == jsch.predicted_pace
    for name in ("uniform", "adatopk"):
        assert tplans[name].edge_ratio == jplans[name].edge_ratio
        assert tplans[name].encoding == jplans[name].encoding
        t, j = tsims[name], jsims[name]
        assert t.iteration_time == j.iteration_time
        assert t.comm_bytes == j.comm_bytes
        assert t.device_busy == j.device_busy
        assert t.events == j.events
    assert any(r > 1.0 for r in tplans["adatopk"].edge_ratio.values())


def _full(side_core, resolve, gpt, testbed, layers=None):
    cfg = resolve("gpt2-xl").full
    graph = gpt(cfg.replace(n_layers=layers) if layers else cfg, BATCH, SEQ)
    return graph, graph.annotate(SHAPES), \
        side_core.network.paper_testbed(testbed, seed=0)


@pytest.mark.parametrize("testbed", [1, 2])
def test_gpt2_xl_full_joint_plan_fill_and_throughput_equal_jax(testbed):
    """``schedule_joint`` (the elastic runtime's planner), its AdaTopK plan
    and ``verify_plan`` / ``verify_cost_model``, the cold-pipeline fill the
    controller charges, and the Eq. 2-4 throughput model, exactly."""
    import sys
    import repro.core as jc
    import repro_torch.core as tc
    from repro.check import costs as j_costs
    from repro_torch.check import costs as t_costs
    out = []
    for core, resolve, gpt, costs in ((jc, j_resolve, j_gpt, j_costs),
                                      (tc, t_resolve, t_gpt, t_costs)):
        # the package's ``throughput`` attribute is the function
        tp = sys.modules[core.__name__ + ".throughput"]
        graph, prof, cluster = _full(core, resolve, gpt, testbed)
        jp = core.schedule_joint(graph, prof, cluster, ratio=100.0)
        sch = jp.schedule
        assert costs.verify_plan(graph, prof, jp.plan,
                                 placement=sch.placement,
                                 cost_model=jp.cost_model) == []
        assert costs.verify_cost_model(jp.cost_model, sch.placement) == []
        ops = core.estimate_op_costs(graph, prof, cluster, sch.placement)
        loads = core.node_loads(ops, sch.placement, len(cluster))
        est = {n: core.estimate_iteration(graph, prof, cluster,
                                          sch.placement, n_micro=n,
                                          batch_size=BATCH)
               for n in (1, 2, 8)}
        out.append([
            sch.assignment, sch.stages, sch.predicted_pace,
            jp.plan.edge_ratio, jp.predicted_pace, jp.iterations,
            jp.converged,
            core.pipeline_fill_seconds(graph, prof, sch, cluster, jp.plan),
            core.pipeline_fill_seconds(graph, prof, sch, cluster,
                                       cost_model=jp.cost_model),
            [(ld.comp, ld.recv) for ld in loads],
            core.latency_single_pass(loads),
            [core.latency_pipelined(loads, n) for n in (1, 2, 8)],
            core.throughput(loads, 8, BATCH),
            {n: (e.iteration_time, e.samples_per_sec, e.fwd_loads,
                 e.bwd_loads)
             for n, e in est.items()},
            tp.peak_activation_bytes(
                graph, prof, sch.placement, len(cluster), 2),
            tp.memory_feasible(graph, prof, cluster,
                                                sch.placement, 2)])
    assert [repr(x) for x in out[1]] == [repr(x) for x in out[0]]
    assert out[1][3]                    # something compressed


@pytest.mark.parametrize("mode", ["stop", "overlap"])
def test_gpt2_xl_full_elastic_drive_equals_jax(mode):
    """The elastic drive, timing-only here: gpt2-xl full on paper testbed
    1 under the joint planner (ratio 100), one stage host of the probe's
    schedule lost at 0.4 of a 6-step run, lease 1.5 probe iterations,
    checkpoints every 3 steps, 2 kept.  Epochs, steps, clock and plans
    equal the JAX controller's."""
    _elastic_drive_equals_jax(mode, None)


@pytest.mark.parametrize("mode", ["stop", "overlap"])
def test_gpt2_xl_cut_elastic_drive_equals_jax(mode):
    """The same drive at the depth ``chip_smoke.py`` trains on the card
    (``ELASTIC_LAYERS``: 6 of gpt2-xl's 48 layers, at full width)."""
    _elastic_drive_equals_jax(mode, 6)


def _elastic_drive_equals_jax(mode, layers):
    import dataclasses
    import repro.elastic as je
    import repro.core as jc
    import repro_torch.elastic as te
    import repro_torch.core as tc
    out = []
    for core, el, resolve, gpt, kw in (
            (jc, je, j_resolve, j_gpt, {}),
            (tc, te, t_resolve, t_gpt, {"device": "cpu",
                                         "use_kernel": "auto"})):
        graph, prof, cluster = _full(core, resolve, gpt, 1, layers)
        common = dict(n_micro=2, planner="joint", joint_ratio=100.0, **kw)
        probe = el.ElasticController(graph, prof, cluster,
                                     el.ChurnTrace(()), **common)
        t1 = probe.run(steps=1).steps[0].step_seconds
        victim = probe.schedule.stage_devices()[2]
        ctrl = el.ElasticController(
            graph, prof, cluster,
            el.single_failure_trace(victim, at=0.4 * 6 * t1),
            lease_s=1.5 * t1, migration_mode=mode, checkpoint_interval=3,
            checkpoint_history=2, **common)
        res = ctrl.run(steps=6)
        out.append(([dataclasses.asdict(e) for e in res.epochs],
                    [dataclasses.asdict(s) for s in res.steps],
                    res.total_seconds, ctrl.plan.edge_ratio,
                    ctrl.schedule.assignment))
    assert out[1] == out[0]
    epochs = out[1][0]
    assert [e["cause"] for e in epochs][:2] == ["initial", "failure"]
    assert epochs[1]["rollback_steps"] > 0 and out[1][3]
