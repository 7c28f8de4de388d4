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
