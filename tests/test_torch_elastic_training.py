"""Training through churn: the port's ``ElasticController`` with real RAD
numerics against the JAX package's, on the CPU.

Runs start from the JAX package's weights (``from_numpy_tree``).  Their
epoch and step records (clock, rollbacks, migrations) must EQUAL the
reference's, their losses match it within rtol 1e-4 (fp32, different
summation orders), and a run through a failure under the dense planner
must reproduce the uninterrupted run step for step (rel 1e-6, as the JAX
package's own test asserts).  The JAX package differentiates eagerly here
(seconds a step for the 6-layer GPT), so it trains the MLP here, runs the
6-layer GPT timing-only, and holds a 2-layer GPT's compressed losses
through the failure step by step, from the port's state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.data.synthetic import SyntheticLM  # noqa: E402
from repro.models.opgraph_models import gpt_opgraph as j_gpt  # noqa: E402
from repro_torch import core as t_core  # noqa: E402
from repro_torch import elastic as t_el  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.models.opgraph_models import gpt_opgraph as t_gpt  # noqa: E402
from repro_torch.optim import optimizers as t_optim  # noqa: E402
from test_torch_elastic import CPU, J, T, _np, _probe, _run, t_mlp_chain  # noqa: E402

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while these runs train: their tensors are small,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt(m, n_layers=6, d=64, vocab=128, batch=8, seq=32):
    kw = dict(name="gpt-elastic-demo", family="dense", n_layers=n_layers,
              d_model=d, n_heads=4, n_kv_heads=4, d_ff=2 * d, vocab=vocab,
              rope_fraction=0.0, max_seq=seq, norm="layernorm", act="gelu")
    jg = j_gpt(JModelCfg(**kw), batch, seq)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    params = jg.init(jax.random.PRNGKey(0), shapes)
    g = jg if m is J else t_gpt(TModelCfg(**kw), batch, seq)
    if m is T:
        params = from_numpy_tree(_np(params), CPU)
    ds = SyntheticLM(vocab=vocab, seq_len=seq, seed=0, order=1)

    def data_fn(step):
        b = ds.batch(batch, step)
        mb = batch // 2
        return [{k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
                for i in range(2)]
    return g, g.annotate(shapes), params, data_fn


def _elastic_run(m, mode, planner, fail=True, steps=8):
    """The elastic example's drive: one stage host of the probe's schedule
    dies at 0.4 of the run, the lease is 1.5 probe iterations."""
    g, prof, params, data_fn = _gpt(m)
    cluster = m.network.paper_testbed(1, seed=0)
    probe, t1 = _probe(m, g, prof, cluster, planner=planner, joint_ratio=8.0)
    victim = probe.schedule.stage_devices()[2]
    trace = m.single_failure_trace(victim, at=0.4 * steps * t1) if fail \
        else m.ChurnTrace(())
    ctrl = m.EC(g, prof, cluster, trace, optimizer=m.optim.adamw(lr=3e-3),
                n_micro=2, lease_s=1.5 * t1, migration_mode=mode,
                planner=planner, joint_ratio=8.0)
    return ctrl, ctrl.run(steps=steps, data_fn=data_fn, params=params)


def _assert_losses_close(t_res, j_res, rtol):
    lt = [s.loss for s in t_res.steps]
    lj = [s.loss for s in j_res.steps]
    np.testing.assert_allclose(lt, lj, rtol=rtol)


@pytest.mark.parametrize("mode", ["stop", "overlap"])
def test_joint_failover_training_matches_jax(mode):
    """AdaTopK boundaries under the joint planner (ratio 64; the initial
    plan compresses all 7 boundaries) on the fat-pipe sites, one stage host
    lost: a 12-layer d128 MLP trains through both packages from the same
    weights.  Epochs, steps and clock equal the
    reference's; losses, lost steps included, within rtol 1e-4."""
    out = {}
    for name, m in (("jax", J), ("torch", T)):
        g, shapes, params, inputs = m.mlp_chain(n_layers=12, d=128, batch=8)
        prof = g.annotate(shapes)
        cluster = m.network.fat_pipe_sites(n=8, n_sites=2, seed=0)
        kw = dict(planner="joint", joint_ratio=64.0)
        probe, t1 = _probe(m, g, prof, cluster, **kw)
        victim = probe.schedule.stage_devices()[1]
        ctrl = m.EC(g, prof, cluster,
                    m.single_failure_trace(victim, at=2.5 * t1),
                    optimizer=m.optim.adamw(lr=1e-3), n_micro=2, lease_s=t1,
                    migration_mode=mode, **kw)
        res = ctrl.run(steps=5, data_fn=lambda s: [inputs, inputs],
                       params=params)
        out[name] = (ctrl, res)
    (cj, rj), (ct, rt) = out["jax"], out["torch"]
    assert _run(rt) == _run(rj)
    assert any(e.cause == "failure" and e.rollback_steps for e in rt.epochs)
    assert any(s.lost for s in rt.steps) and rt.useful_steps == 5
    assert ct.plan.edge_ratio == cj.plan.edge_ratio and ct.plan.edge_ratio
    _assert_losses_close(rt, rj, LOSS_RTOL)


def test_gpt_joint_failover_epochs_equal_jax():
    """The elastic example's GPT (6 layers, d_model 64) through the failure
    under the joint planner (ratio 8): the port trains, and its epoch and
    step records and clock equal the JAX controller's on the same trace
    (timing-only there: the JAX package differentiates this model eagerly
    at seconds a step)."""
    ct, rt = _elastic_run(T, "stop", "joint")
    g, prof, _, _ = _gpt(J)
    cluster = J.network.paper_testbed(1, seed=0)
    probe, t1 = _probe(J, g, prof, cluster, planner="joint", joint_ratio=8.0)
    victim = probe.schedule.stage_devices()[2]
    cj = J.EC(g, prof, cluster, J.single_failure_trace(victim, at=0.4 * 8 * t1),
              n_micro=2, lease_s=1.5 * t1, planner="joint", joint_ratio=8.0)
    rj = cj.run(steps=8)
    assert _run(rt) == _run(rj)
    assert ct.plan.edge_ratio == cj.plan.edge_ratio and ct.plan.edge_ratio
    assert any(e.cause == "failure" and e.rollback_steps for e in rt.epochs)
    assert rt.useful_steps == 8
    assert all(np.isfinite(s.loss) for s in rt.steps)


def test_gpt_joint_failover_losses_match_jax():
    """The example's GPT cut to 2 layers (d_model 64) trains through the
    failure under the joint planner (ratio 8, every boundary compressed):
    a rollback of 2 steps and an anchored re-plan with moves.  Its records
    equal the JAX controller's on the same trace, and the loss of every
    step it ran — lost, replayed and migrated ones included — equals, within
    rtol 1e-4, the JAX pipeline's loss on the parameters and micro-batches
    that step trained from, under the JAX controller's plan of the same
    epoch.  The first replayed step trains from exactly the state the first
    lost one did.

    Each step's loss is held against JAX from the port's own state, not
    from a second, free-running JAX run: the logits gradient into the head
    is the gradient of cross-entropy over top-k compressed logits, whose
    zeroed entries tie in groups of a row each (about 120 of 128), and the
    Top-K threshold falls on such a group.  A 1-ulp difference in the
    softmax between the two packages moves a whole group across the
    threshold, so the two runs' gradients part after the first step."""
    from repro.core import rad as j_rad
    from repro.elastic import ElasticController as JController
    from repro_torch.checkpoint import to_numpy_tree

    steps, kw = 6, dict(planner="joint", joint_ratio=8.0)
    g, prof, params, data_fn = _gpt(T, n_layers=2)
    cluster = T.network.paper_testbed(1, seed=0)
    probe, t1 = _probe(T, g, prof, cluster, **kw)
    victim = probe.schedule.stage_devices()[2]
    trained_from = []
    adamw = t_optim.adamw(lr=3e-3)

    def update(grads, state, p):
        trained_from.append(to_numpy_tree(p))
        return adamw.update(grads, state, p)

    rt = T.EC(g, prof, cluster,
              T.single_failure_trace(victim, at=0.4 * steps * t1),
              optimizer=t_optim.Optimizer(init=adamw.init, update=update),
              n_micro=2, lease_s=1.5 * t1, migration_mode="stop",
              **kw).run(steps=steps, data_fn=data_fn, params=params)

    runtimes = []

    class KeepRuntimes(JController):
        def _install_schedule(self, *args, **kwargs):
            super()._install_schedule(*args, **kwargs)
            runtimes.append(self.runtime)

    jg, jprof, _, _ = _gpt(J, n_layers=2)
    jcluster = J.network.paper_testbed(1, seed=0)
    _, jt1 = _probe(J, jg, jprof, jcluster, **kw)
    rj = KeepRuntimes(jg, jprof, jcluster,
                      J.single_failure_trace(victim, at=0.4 * steps * jt1),
                      n_micro=2, lease_s=1.5 * jt1, migration_mode="stop",
                      **kw).run(steps=steps)
    assert _run(rt) == _run(rj)
    fail = [e for e in rt.epochs if e.cause == "failure"]
    assert len(fail) == 1 and fail[0].rollback_steps and fail[0].n_moves
    assert any(s.lost for s in rt.steps) and rt.useful_steps == steps
    assert len(runtimes) == len(rj.epochs) and len(trained_from) == \
        len(rt.steps)
    # the first replayed step trains from the restored and migrated state:
    # bit for bit the state the first lost step trained from
    lost = next(i for i, s in enumerate(rt.steps) if s.lost)
    replay = next(i for i, s in enumerate(rt.steps)
                  if i > lost and s.step == rt.steps[lost].step)
    assert not rt.steps[replay].lost
    a, b = trained_from[lost], trained_from[replay]
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    assert all(np.array_equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    for rec, p in zip(rt.steps, trained_from):
        jrt = runtimes[rec.epoch]
        assert jrt.plan.edge_ratio and all(
            r > 1.0 for r in jrt.plan.edge_ratio.values())
        jp = jax.tree_util.tree_map(jax.numpy.asarray, p)
        mb_losses = [j_rad.pipeline_forward(jrt.prog, jp, mb, jrt.plan)[0]
                     for mb in data_fn(rec.step - 1)]
        want = float((mb_losses[0] + mb_losses[1]) / 2.0)
        assert rec.loss == pytest.approx(want, rel=LOSS_RTOL), rec


@pytest.mark.parametrize("mode", ["stop", "overlap"])
def test_opfence_failover_equals_uninterrupted_run(mode):
    """Dense boundaries: a run through the failure reproduces the run with
    no failure step for step (rel 1e-6) and ends in the same state; the
    epochs equal the JAX controller's (timing-only, same trace)."""
    base_ctrl, base = _elastic_run(T, mode, "opfence", fail=False)
    ctrl, res = _elastic_run(T, mode, "opfence")
    assert any(e.cause == "failure" for e in res.epochs)
    lb, lc = dict(base.losses), dict(res.losses)
    assert set(lb) == set(lc) == set(range(1, 9))
    for s in lb:
        assert lc[s] == pytest.approx(lb[s], rel=1e-6, abs=1e-7)
    assert max(l for _, l in res.losses[-2:]) < res.losses[0][1]
    assert t_el.trees_bitexact(res.params, base.params)
    g, prof, _, _ = _gpt(J)
    cluster = J.network.paper_testbed(1, seed=0)
    probe, t1 = _probe(J, g, prof, cluster, planner="opfence")
    victim = probe.schedule.stage_devices()[2]
    jres = J.EC(g, prof, cluster,
                J.single_failure_trace(victim, at=0.4 * 8 * t1), n_micro=2,
                lease_s=1.5 * t1, migration_mode=mode,
                planner="opfence").run(steps=8)
    assert _run(res) == _run(jres)


def test_mlp_overlap_failover_matches_jax():
    """``test_overlap_training_loss_identical_to_uninterrupted`` through
    both packages: epochs, clock and migration equal; losses within rtol
    1e-4 of JAX and rel 1e-6 of the port's uninterrupted run."""
    out = {}
    for name, m in (("jax", J), ("torch", T)):
        g, shapes, params, inputs = m.mlp_chain(n_layers=8, d=64, batch=4)
        prof = g.annotate(shapes)
        cluster = m.network.geo_random(n=6, n_sites=2, seed=3)
        probe, t1 = _probe(m, g, prof, cluster)
        victim = probe.schedule.stage_devices()[1]
        runs = []
        for trace in (m.ChurnTrace(()),
                      m.single_failure_trace(victim, at=2.5 * t1)):
            ctrl = m.EC(g, prof, cluster, trace,
                        optimizer=m.optim.adamw(lr=1e-3), n_micro=2,
                        lease_s=t1, migration_mode="overlap")
            runs.append(ctrl.run(steps=8, data_fn=lambda s: [inputs, inputs],
                                 params=params))
        out[name] = runs
    (jb, jr), (tb, tr) = out["jax"], out["torch"]
    assert any(e.cause == "failure" for e in tr.epochs)
    assert _run(tr) == _run(jr) and _run(tb) == _run(jb)
    _assert_losses_close(tr, jr, LOSS_RTOL)
    lb, lc = dict(tb.losses), dict(tr.losses)
    assert set(lb) == set(lc)
    for s in lb:
        assert lc[s] == pytest.approx(lb[s], rel=1e-6, abs=1e-7)
    assert t_el.trees_bitexact(tr.params, tb.params)


def test_controller_metrics_read_residual_norms_on_the_tensors_device():
    """With a metrics registry and an error-feedback plan, each step sets one
    ``ef_residual_norm`` gauge a residual (a torch norm, no numpy copy)."""
    from repro_torch.core.compression import plan_uniform
    from repro_torch.obs import MetricsRegistry
    g, shapes, params, inputs = t_mlp_chain(n_layers=8, d=64, batch=4)
    prof = g.annotate(shapes)
    cluster = T.network.geo_random(n=6, n_sites=2, seed=3)
    reg = MetricsRegistry()
    ctrl = T.EC(g, prof, cluster, T.ChurnTrace(()),
                optimizer=t_optim.adamw(lr=1e-3), n_micro=2, metrics=reg,
                plan_factory=lambda gr, pr, cl, pl: plan_uniform(
                    gr, pl, 4.0, error_feedback=True))
    ctrl.run(steps=2, data_fn=lambda s: [inputs, inputs], params=params)
    ef = ctrl.runtime.ef_state
    assert ef
    snap = reg.snapshot()
    for a in ef:
        want = float(np.linalg.norm(ef[a].numpy()))
        assert snap[f"ef_residual_norm{{edge={a}}}"] == \
            pytest.approx(want, rel=1e-6)
