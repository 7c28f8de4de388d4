"""The slice as a whole: OP-DAG → OP-Fence → AdaTopK → RAD → AdamW, in the
port against itself and against the JAX package, at smoke size on the CPU.

* Without compression, RAD must reproduce single-device autograd (the
  contract in the ``rad.py`` docstring) and match JAX within fp32
  tolerance (rtol 1e-5, atol 1e-6: the frameworks sum in other orders).
* With compression under ``use_kernel="auto"`` (the plain codec here,
  JAX's ``"xla"`` mode), the loss must match within rtol 1e-4 and each
  gradient within a relative-norm error of 1e-3: Top-K selection is
  discontinuous, so a near-tie can flip on a 1e-7 difference in an
  activation.  The codec itself is held bit-exact in test_torch_kernels.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro import optim as j_optim  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.checkpoint import to_numpy_tree  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from test_torch_models import (ATOL, CPU, RTOL, _assert_trees_close,  # noqa: E402
                               _np_tree, smoke_setup)


def _schedules(s):
    """The same OP-Fence schedule on paper testbed 1, from each package."""
    prof_j = s["gj"].annotate(s["shapes"])
    prof_t = s["gt"].annotate(s["shapes"])
    cl_j = J.network.paper_testbed(1, seed=0)
    cl_t = T.network.paper_testbed(1, seed=0)
    sch_j = J.schedule_opfence(s["gj"], prof_j, cl_j)
    sch_t = T.schedule_opfence(s["gt"], prof_t, cl_t)
    assert sch_t.assignment == sch_j.assignment
    assert len(sch_t.stage_devices()) > 2
    return (prof_j, cl_j, sch_j), (prof_t, cl_t, sch_t)


def _programs(s, sch_j, sch_t):
    return (J.PipelineProgram.build(s["gj"], sch_j.pipeline_subdags(s["gj"])),
            T.PipelineProgram.build(s["gt"], sch_t.pipeline_subdags(s["gt"])))


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_rad_uncompressed_equals_single_device_and_jax():
    s = smoke_setup()
    (_, _, sch_j), (_, _, sch_t) = _schedules(s)
    prog_j, prog_t = _programs(s, sch_j, sch_t)
    loss_t, grads_t = T.pipeline_loss_and_grad(prog_t, s["pt"], s["it"])
    loss_sd, grads_sd = T.single_device_loss_and_grad(s["gt"], s["pt"],
                                                      s["it"])
    assert float(loss_t) == float(loss_sd)
    _assert_trees_close(grads_t, grads_sd, rtol=0, atol=0)
    loss_j, grads_j = J.pipeline_loss_and_grad(prog_j, s["pj"], s["ij"])
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL,
                               atol=ATOL)
    _assert_trees_close(grads_t, grads_j)


@pytest.mark.parametrize("compress", ["uniform", "adatopk"])
def test_rad_compressed_auto_matches_jax(compress):
    s = smoke_setup(seed=1)
    (prof_j, cl_j, sch_j), (prof_t, cl_t, sch_t) = _schedules(s)
    prog_j, prog_t = _programs(s, sch_j, sch_t)
    if compress == "uniform":
        plan_j = J.plan_uniform(s["gj"], sch_j.placement, 10.0)
        plan_t = T.plan_uniform(s["gt"], sch_t.placement, 10.0)
    else:
        plan_j = J.plan_adatopk(s["gj"], prof_j, cl_j, sch_j.placement, 10.0)
        plan_t = T.plan_adatopk(s["gt"], prof_t, cl_t, sch_t.placement, 10.0)
    assert plan_t.edge_ratio == plan_j.edge_ratio and plan_t.edge_ratio
    loss_t, grads_t = T.pipeline_loss_and_grad(prog_t, s["pt"], s["it"],
                                               plan_t, use_kernel="auto")
    loss_j, grads_j = J.pipeline_loss_and_grad(prog_j, s["pj"], s["ij"],
                                               plan_j, use_kernel="auto")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    dense_t, _ = T.pipeline_loss_and_grad(prog_t, s["pt"], s["it"])
    assert float(loss_t) != float(dense_t)          # compression bit
    t_np, j_np = to_numpy_tree(grads_t), _np_tree(grads_j)
    for a, b in zip(jax.tree_util.tree_leaves(t_np),
                    jax.tree_util.tree_leaves(j_np)):
        assert _rel_err(a, b) < 1e-3


def test_rad_error_feedback_matches_jax():
    s = smoke_setup(seed=2)
    (_, _, sch_j), (_, _, sch_t) = _schedules(s)
    prog_j, prog_t = _programs(s, sch_j, sch_t)
    plan_j = J.plan_uniform(s["gj"], sch_j.placement, 10.0,
                            error_feedback=True)
    plan_t = T.plan_uniform(s["gt"], sch_t.placement, 10.0,
                            error_feedback=True)
    ef_t = T.init_ef_state(prog_t, s["pt"], s["it"])
    ef_j = J.init_ef_state(prog_j, s["pj"], s["ij"])
    for _ in range(2):
        loss_t, grads_t, ef_t = T.pipeline_loss_and_grad_ef(
            prog_t, s["pt"], s["it"], plan_t, ef_t, use_kernel="auto")
        loss_j, grads_j, ef_j = J.pipeline_loss_and_grad_ef(
            prog_j, s["pj"], s["ij"], plan_j, ef_j, use_kernel="auto")
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for a in ef_t:
        assert _rel_err(ef_t[a].numpy(), np.asarray(ef_j[a])) < 1e-3


def test_runtime_adamw_loss_curve_matches_jax():
    s = smoke_setup(batch=4, seq=16, seed=3)
    (_, _, sch_j), (_, _, sch_t) = _schedules(s)
    plan_j = J.plan_uniform(s["gj"], sch_j.placement, 10.0)
    plan_t = T.plan_uniform(s["gt"], sch_t.placement, 10.0)
    rt_t = T.DecentralizedRuntime(s["gt"], sch_t, plan_t, use_kernel="auto",
                                  device="cpu")
    rt_j = J.DecentralizedRuntime(s["gj"], sch_j, plan_j, use_kernel="auto")
    opt_t = t_optim.adamw(t_optim.linear_warmup_cosine(3e-3, 2, 4),
                          weight_decay=0.01)
    opt_j = j_optim.adamw(j_optim.linear_warmup_cosine(3e-3, 2, 4),
                          weight_decay=0.01)
    pt, pj = s["pt"], s["pj"]
    st_t, st_j = opt_t.init(pt), opt_j.init(pj)
    ds = SyntheticLM(vocab=s["cfg"].vocab, seq_len=16, seed=0, order=1)
    curve_t, curve_j = [], []
    for step in range(4):
        b = ds.batch(4, step)
        loss_t, g_t = rt_t.train_step(pt, [b])
        pt, st_t = opt_t.update(g_t, st_t, pt)
        loss_j, g_j = rt_j.train_step(
            pj, [{k: jnp.asarray(v) for k, v in b.items()}])
        pj, st_j = opt_j.update(g_j, st_j, pj)
        curve_t.append(float(loss_t))
        curve_j.append(float(loss_j))
    np.testing.assert_allclose(curve_t, curve_j, rtol=1e-4)
    assert len(rt_t.traffic) == len(rt_j.traffic)
    assert curve_t[-1] < curve_t[0]


def test_adamw_update_matches_jax():
    s = smoke_setup(seed=4)
    rng = np.random.default_rng(4)
    g_np = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _np_tree(s["pj"]))
    from repro_torch.checkpoint import from_numpy_tree
    g_t = from_numpy_tree(g_np, CPU)
    g_j = jax.tree_util.tree_map(jnp.asarray, g_np)
    for opt_t, opt_j in (
            (t_optim.adamw(t_optim.cosine_schedule(1e-2, 5)),
             j_optim.adamw(j_optim.cosine_schedule(1e-2, 5))),
            (t_optim.sgd(1e-2, nesterov=True, weight_decay=0.1),
             j_optim.sgd(1e-2, nesterov=True, weight_decay=0.1))):
        pt, pj = s["pt"], s["pj"]
        st_t, st_j = opt_t.init(pt), opt_j.init(pj)
        for _ in range(3):
            pt, st_t = opt_t.update(g_t, st_t, pt)
            pj, st_j = opt_j.update(g_j, st_j, pj)
        _assert_trees_close(pt, pj)
    clipped_t, gn_t = t_optim.clip_by_global_norm(g_t, 1.0)
    clipped_j, gn_j = j_optim.clip_by_global_norm(g_j, 1.0)
    np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=RTOL)
    _assert_trees_close(clipped_t, clipped_j)


def test_launcher_fusion_runs_on_cpu():
    losses = t_train.main(["--device", "cpu", "--steps", "3",
                           "--compress", "adatopk", "--ratio", "10",
                           "--log-every", "100", "--quiet"])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    with pytest.raises(SystemExit):
        t_train.main(["--mode", "gspmd", "--device", "cpu"])


def test_train_fusion_error_feedback_codec_calls_and_residuals(monkeypatch):
    """The EF-SGD step runs one codec round trip per compressed message in
    each direction: the forward activation through ``boundary_compress``
    (whose input is detached, so its own backward never runs a codec) and
    the gradient through ``topk_mask(g + r)``.  After the run every
    compressed gradient edge holds a non-zero residual."""
    from repro_torch.configs import resolve
    from repro_torch.kernels import topk_compress as ttk
    calls = {"encode_topk": 0, "decode_topk": 0}
    for name in calls:
        real = getattr(ttk, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ttk, name, counting)
    steps = 2
    run = t_train.train_fusion(resolve("gpt2-xl").smoke, batch=2, seq=16,
                               steps=steps, compress="uniform", ratio=10.0,
                               device="cpu", data_order=1,
                               error_feedback=True, log_every=100)
    prog, plan = run.runtime.prog, run.plan
    assert plan.error_feedback and all(math.isfinite(x) for x in run.losses)
    msgs = sum(
        1 for sd in prog.subdags for a in sd.required_acti
        if max([plan.ratio(a, c) for c in sd.node_names
                if a in prog.graph.nodes[c].args] or [1.0]) > 1.0)
    assert msgs > 0
    assert calls == {"encode_topk": msgs * 2 * steps,
                     "decode_topk": msgs * 2 * steps}
    ef = run.runtime.ef_state
    assert sum(int(bool((r != 0).any())) for r in ef.values()) == msgs
