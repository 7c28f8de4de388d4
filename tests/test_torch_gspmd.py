"""The gspmd training path on one device: Adafactor, the device loader,
``make_train_step`` and the launcher's ``train_gspmd``, against the JAX
package on the same weights and ``SyntheticLM`` batches, on the CPU.

Three steps are held at rtol 1e-4: losses and ``grad_norm``, and the
parameters entry by entry (atol 1e-6).  Under AdamW a few entries are
allowed outside that, at most 1e-4 of a leaf's entries, each within two
AdamW steps of the learning rate a step: an entry whose gradient is at the
rounding level of the sum that makes it (|g| ~ 3e-8 against a median of
7e-4 in ``wk`` at gpt2-smoke, where the two frameworks differ by up to
1e-8) is divided by ``sqrt(v) + 1e-8``, so each framework moves it by
another fraction of the learning rate, or the other way (1 of 65,536 in
llama3-smoke's embedding table after 3 steps).  Elsewhere the forward and
backward sum in other orders in the two frameworks, and the optimizers
carry that on.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.distributed.steps import make_train_step as j_make_step  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.core.rad import tree_map as t_tree_map  # noqa: E402
from repro_torch.data import ShardedLoader, SyntheticLM  # noqa: E402
from repro_torch.distributed import make_train_step as t_make_step  # noqa: E402
from repro_torch.distributed.steps import loss_and_grad as t_loss_and_grad  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from test_torch_causal_lm import _cfgs, lm_setup  # noqa: E402
from test_torch_models import ATOL, CPU, _assert_trees_close, _np_tree  # noqa: E402

STEP_RTOL = 1e-4


def _assert_adamw_params_close(t_tree, j_tree, lr_sum):
    t_np, j_np = to_numpy_tree(t_tree), _np_tree(j_tree)
    assert jax.tree_util.tree_structure(t_np) == \
        jax.tree_util.tree_structure(j_np)
    for a, b in zip(jax.tree_util.tree_leaves(t_np),
                    jax.tree_util.tree_leaves(j_np)):
        off = np.abs(a - b) > ATOL + STEP_RTOL * np.abs(b)
        assert off.sum() <= 1e-4 * off.size
        assert np.all(np.abs(a - b) <= 2 * lr_sum)


def _opts(name, lr):
    if name == "adamw":
        return (t_optim.adamw(t_optim.linear_warmup_cosine(lr, 10, 3),
                              weight_decay=0.0),
                j_optim.adamw(j_optim.linear_warmup_cosine(lr, 10, 3),
                              weight_decay=0.0))
    return t_optim.adafactor(lr), j_optim.adafactor(lr)


# -------------------------------------------------------------- adafactor --
def _stacked_tree(seed=0):
    """A stacked norm scale (L, d), a stacked matrix (L, d, f), a matrix
    and a vector: every branch of Adafactor."""
    rng = np.random.default_rng(seed)
    shapes = {"ln": {"scale": (4, 24)}, "w": (4, 24, 12), "head": (24, 40),
              "bias": (40,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return draw(shapes), draw(shapes)


def test_adafactor_matches_jax_and_factors_stacked_leaves():
    p_np, g_np = _stacked_tree()
    opt_t, opt_j = _opts("adafactor", 1e-2)
    pt, gt = from_numpy_tree(p_np, CPU), from_numpy_tree(g_np, CPU)
    pj = jax.tree_util.tree_map(jnp.asarray, p_np)
    gj = jax.tree_util.tree_map(jnp.asarray, g_np)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    # the (L, d) norm scale is a matrix: r has an entry per layer, c one
    # per feature
    assert st.inner["ln"]["scale"]["r"].shape == (4,)
    assert st.inner["ln"]["scale"]["c"].shape == (24,)
    assert st.inner["w"]["r"].shape == (4, 24)
    assert st.inner["w"]["c"].shape == (4, 12)
    assert set(st.inner["bias"]) == {"v"}
    for _ in range(3):
        pt, st = opt_t.update(gt, st, pt)
        pj, sj = opt_j.update(gj, sj, pj)
    assert int(st.step) == int(sj.step) == 3
    _assert_trees_close(pt, pj, rtol=1e-5)
    _assert_trees_close(st.inner, sj.inner, rtol=1e-5)


def test_adafactor_clips_a_stacked_leaf_as_a_whole():
    """The update's RMS clip runs over all layers of a stacked leaf; a loop
    over the layers would give other numbers (layer 0's gradient is large
    enough for its own clip to bite, the others' are not)."""
    g = np.random.default_rng(1).standard_normal((3, 8, 8)).astype(np.float32)
    g[0] *= 50.0
    p = np.zeros_like(g)
    opt = t_optim.adafactor(1.0)
    whole, _ = opt.update({"w": torch.from_numpy(g)},
                          opt.init({"w": torch.from_numpy(p)}),
                          {"w": torch.from_numpy(p)})
    per_layer = []
    for i in range(3):
        out, _ = opt.update({"w": torch.from_numpy(g[i])},
                            opt.init({"w": torch.from_numpy(p[i])}),
                            {"w": torch.from_numpy(p[i])})
        per_layer.append(out["w"])
    assert not torch.allclose(whole["w"], torch.stack(per_layer))
    opt_j = j_optim.adafactor(1.0)
    want, _ = opt_j.update({"w": jnp.asarray(g)},
                           opt_j.init({"w": jnp.asarray(p)}),
                           {"w": jnp.asarray(p)})
    np.testing.assert_allclose(whole["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- loader --
def test_adafactor_consuming_its_gradients_gives_the_same_numbers():
    """``update(..., consume_grads=True)`` writes each fp32 leaf's new value
    into its gradient's memory and gives the functional update's numbers
    bit for bit; ``distinct_storage`` copies a gradient whose memory
    another leaf's shares, or whose entries share memory; and
    ``make_train_step`` (which clips in place and lets the update consume
    its gradients) gives a functional step's parameters, state and
    metrics bit for bit over three steps."""
    params, grads = _stacked_tree(3)
    opt = t_optim.adafactor(1e-2)
    pt = from_numpy_tree(params, CPU)
    want, want_st = opt.update(from_numpy_tree(grads, CPU), opt.init(pt), pt)
    gt = from_numpy_tree(grads, CPU)
    ptrs = {k: v.data_ptr() for k, v in gt.items() if k != "ln"}
    got, got_st = opt.update(gt, opt.init(pt), pt, consume_grads=True)
    for a, b in zip(jax.tree_util.tree_leaves((got, got_st.inner)),
                    jax.tree_util.tree_leaves((want, want_st.inner))):
        assert torch.equal(a, b)
    assert {k: got[k].data_ptr() for k in ptrs} == ptrs
    g = torch.ones(3)
    owned = t_optim.distinct_storage({"a": g, "b": g,
                                      "c": torch.ones(1).expand(3)})
    assert owned["a"] is g and owned["b"] is not g
    assert torch.equal(owned["b"], g)
    assert owned["c"].stride() == (1,)

    def functional_step(p, st, batch):
        """loss_and_grad, the clip written out with new tensors, and the
        update that leaves its inputs as they were."""
        loss, metrics, grads = t_loss_and_grad(s["cfg_t"], p, batch)
        leaves = jax.tree_util.tree_leaves(grads)
        gn = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                            for x in leaves))
        scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-12), max=1.0)
        grads = t_tree_map(lambda x: (x * scale).to(x.dtype), grads)
        p, st = opt.update(grads, st, p)
        return p, st, {"loss": loss, "grad_norm": gn, **metrics}

    s = lm_setup("llama3-8b")
    ds = SyntheticLM(vocab=s["cfg_t"].vocab, seq_len=16, seed=0)
    runs = []
    for step in (functional_step, t_make_step(s["cfg_t"], opt)):
        p = from_numpy_tree(to_numpy_tree(s["pt"]), CPU)
        st, metrics = opt.init(p), []
        for i in range(3):
            p, st, m = step(p, st, {k: torch.as_tensor(v).long()
                                    for k, v in ds.batch(2, i).items()})
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((p, st.inner, metrics))
    for a, b in zip(jax.tree_util.tree_leaves(runs[0][:2]),
                    jax.tree_util.tree_leaves(runs[1][:2])):
        assert torch.equal(a, b)
    assert runs[0][2] == runs[1][2]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_consuming_its_gradients_gives_the_same_numbers(weight_decay):
    """AdamW's ``update(..., consume_grads=True)`` writes each fp32 leaf's
    new value into its gradient's memory and its new moments over those of
    the state it was given (the JAX package's step donates ``params`` and
    ``opt_state``), gives the functional update's parameters and moments
    bit for bit over three steps (a warm-up schedule, so the learning rate
    and both bias corrections move), and leaves the parameters it was given
    as they were."""
    opt = t_optim.adamw(t_optim.linear_warmup_cosine(1e-2, 2, 3),
                        weight_decay=weight_decay)
    params, _ = _stacked_tree(0)
    want_p = got_p = from_numpy_tree(params, CPU)
    want_st, got_st = opt.init(want_p), opt.init(got_p)
    for step in range(3):
        _, grads = _stacked_tree(step + 1)
        want_p, want_st = opt.update(from_numpy_tree(grads, CPU), want_st,
                                     want_p)
        gt = from_numpy_tree(grads, CPU)
        before = [t.clone() for t in jax.tree_util.tree_leaves(got_p)]
        ptrs = [t.data_ptr() for t in jax.tree_util.tree_leaves(gt)]
        moments = jax.tree_util.tree_leaves(got_st.inner)
        new_p, new_st = opt.update(gt, got_st, got_p, consume_grads=True)
        for a, b in zip(jax.tree_util.tree_leaves(got_p), before):
            assert torch.equal(a, b)
        assert [t.data_ptr() for t in jax.tree_util.tree_leaves(new_p)] \
            == ptrs
        assert [t.data_ptr() for t in jax.tree_util.tree_leaves(
            new_st.inner)] == [t.data_ptr() for t in moments]
        got_p, got_st = new_p, new_st
        for a, b in zip(jax.tree_util.tree_leaves((got_p, got_st.inner)),
                        jax.tree_util.tree_leaves((want_p, want_st.inner))):
            assert torch.equal(a, b)
        assert int(got_st.step) == int(want_st.step) == step + 1


def test_sharded_loader_gives_host_values_as_long_on_the_device():
    ds = SyntheticLM(vocab=97, seq_len=12, seed=0, order=1)
    host = [ds.batch(3, i) for i in range(2)]
    loader = ShardedLoader(iter(host), "cpu")
    got = list(loader)
    assert len(got) == 2
    for h, b in zip(host, got):
        assert set(b) == {"tokens", "labels"}
        for k, v in b.items():
            assert v.dtype == torch.long and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), h[k])


# ------------------------------------------------------------- train step --
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["gpt2-xl", "llama3-8b"])
def test_make_train_step_three_steps_match_jax(arch, opt_name):
    s = lm_setup(arch)
    cfg_t, cfg_j = s["cfg_t"], s["cfg_j"]
    opt_t, opt_j = _opts(opt_name, 3e-3)
    step_t = t_make_step(cfg_t, opt_t)
    step_j = jax.jit(j_make_step(cfg_j, opt_j))
    pt, pj = s["pt"], s["pj"]
    st, sj = opt_t.init(pt), opt_j.init(pj)
    ds = JSyntheticLM(vocab=cfg_j.vocab, seq_len=16, seed=0)
    for i in range(3):
        b = ds.batch(2, i)
        pt, st, mt = step_t(pt, st, {k: torch.from_numpy(v).long()
                                     for k, v in b.items()})
        pj, sj, mj = step_j(pj, sj, {k: jnp.asarray(v) for k, v in b.items()})
        assert set(mt) == set(mj) == {"loss", "grad_norm", "ce", "aux"}
        for k in mt:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=STEP_RTOL, atol=ATOL)
    if opt_name == "adafactor":
        _assert_trees_close(pt, pj, rtol=STEP_RTOL, atol=ATOL)
    else:
        lr = t_optim.linear_warmup_cosine(3e-3, 10, 3)
        _assert_adamw_params_close(
            pt, pj, sum(float(lr(torch.tensor(i))) for i in range(3)))


# --------------------------------------------------------------- launcher --
def _jax_launcher_losses(cfg_j, pj, batch, seq, steps, lr):
    """The JAX launcher's ``_train_gspmd`` loop on given weights."""
    opt = j_optim.adamw(j_optim.linear_warmup_cosine(lr, 10, steps),
                        weight_decay=0.0)
    ds = JSyntheticLM(vocab=cfg_j.vocab, seq_len=seq, seed=0)
    step = jax.jit(j_make_step(cfg_j, opt))
    state, losses = opt.init(pj), []
    for i in range(steps):
        b = ds.batch(batch, i)
        pj, state, m = step(pj, state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses


def test_train_gspmd_losses_match_the_jax_launcher():
    cfg_j, cfg_t = _cfgs("llama3-8b")
    pj = j_lm.init(cfg_j, jax.random.PRNGKey(0))
    run = t_train.train_gspmd(cfg_t, batch=2, seq=16, steps=3, lr=3e-3,
                              device="cpu", params=from_numpy_tree(
                                  _np_tree(pj), CPU), log_every=100)
    want = _jax_launcher_losses(cfg_j, pj, 2, 16, 3, 3e-3)
    np.testing.assert_allclose(run.losses, want, rtol=STEP_RTOL)
    assert len(run.step_seconds) == 3 and len(run.metrics) == 3


def test_train_gspmd_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    cfg_j, cfg_t = _cfgs("gpt2-xl")
    run = t_train.train_gspmd(cfg_t, batch=2, seq=16, steps=2, device="cpu",
                              ckpt_dir=str(tmp_path), ckpt_every=2,
                              log_every=100)
    path = tmp_path / "ckpt_00000002.npz"
    assert path.is_file()
    template = j_lm.init(cfg_j, jax.random.PRNGKey(1))
    params, _, meta = j_load(str(path), template)
    assert meta == {"arch": cfg_t.name, "mode": "gspmd", "step": 2}
    got = _np_tree(params)
    want = to_numpy_tree(run.params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_train_gspmd_runs_adafactor_and_the_cli_defaults_to_gspmd():
    cfg = _cfgs("stablelm-12b")[1]
    run = t_train.train_gspmd(cfg, batch=2, seq=8, steps=2, device="cpu",
                              optimizer=t_optim.adafactor(1e-3),
                              log_every=100)
    assert all(math.isfinite(x) for x in run.losses)
    assert "r" in run.opt_state.inner["blocks"]["ln1"]["scale"]
    losses = t_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "8", "--arch", "granite-3-8b",
                           "--quiet"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
