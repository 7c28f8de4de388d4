"""The xLSTM family's train step sharded over a process mesh (DTensor on 4
gloo ranks) against the JAX package's ``build_jitted`` on 4 devices, on
the CPU.

xlstm-smoke cut to 5 layers: 2 groups of one mLSTM and one sLSTM block,
then a 1-layer mLSTM tail.  The weights are the port's ``init`` at seed 0
and the batches come from ``numpy.random.default_rng(1)``, both made here
and handed to the two sides as numpy arrays.  JAX runs in a subprocess
with 4 forced host devices on a ``(2, 2)`` ``("data", "model")`` mesh
with Auto axes, beside one spawn of the port's 4 ranks on the host-staged
group (``torch_spmd_ranks.run_xlstm_ranks``): 2 Adafactor steps of
``build_jitted``'s train step.  The same ranks run the two xLSTM kernels
alone on DTensors, batch on ``data`` and heads on ``model``:
``_mlstm_parallel`` and ``slstm_seq`` (whose time loop runs on each
rank's rows and heads), so that a fault of either shows apart from the
rest of the model.

Tolerances: losses and ``grad_norm`` at rtol 1e-4 a step, as the other
spmd files hold them; every shard's values after each step at atol 1e-6
by mesh position, its shape and index exact, but for the sLSTM bias
``b``.  Its update is rounding noise: the input gate's bias has a
gradient of zero in exact arithmetic, Adafactor scales that gradient's
noise up to the size of a real one, and the leaf's RMS clip spreads it
over the other gates' rows, so JAX's own step on a (1, 1) mesh parts from
its step on the (2, 2) mesh by 1.3e-2 there (and by at most 2.4e-7 on
every other leaf).  One test shows this of JAX; one holds the port's
``b`` as ``test_torch_sharding`` holds such a leaf against JAX on one
device: the other gates' moves up to one scale (1e-4), every entry
within lr × sqrt(size).  The noise of ``b`` reaches every leaf in step 2
(JAX's two layouts part by up to 3.7e-5 then, and their step-2
``grad_norm`` by 5e-5), so step 2 is held against JAX's step from the
port's own state after step 1, which the port's rank 0 writes for JAX's
subprocess to read; step 2's loss is also held against JAX's own second
step.  Step 1's sharded loss against the port's own unsharded step at
rel 1e-6, step 2's at rel 1e-5 (the noise of ``b`` again: it is 2.4e-6).
The kernels alone: outputs and final state at rel 1e-6 of their largest
magnitude, the input and weight gradients, one vector, at rel 1e-5; the
sLSTM's time loop makes as many staged collectives at 16 steps as at 4.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import to_numpy_tree  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models import causal_lm, xlstm  # noqa: E402
import torch_spmd_ranks as ranks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 16
STEP_RTOL = 1e-4
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6            # step 1
UNSHARDED_LATER_RTOL = 1e-5      # step 2: the float64 gap above
LR = 1e-3                        # Adafactor's, in the JAX script too
# the leaf whose update rounding decides (see the test that shows it)
NOISE_LEAF = "groups/s/slstm/b"
KERNEL_RTOL = 1e-6
KERNEL_GRAD_RTOL = 1e-5
TIMEOUT = 240

SCRIPT = textwrap.dedent("""
    import os, sys, time
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import resolve
    from repro.configs.base import InputShape
    from repro.distributed.sharding import use_mesh
    from repro.distributed.steps import build_jitted
    from repro.optim import adafactor

    ARCH, LAYERS, STEPS = {arch!r}, {layers}, {steps}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    cfg = resolve(ARCH).smoke.replace(n_layers=LAYERS)
    B, S = z["batch0/tokens"].shape
    fn, _, _ = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"))
    step = fn
    for k in ("tokens", "labels"):
        out[f"batch1/{{k}}"] = z[f"batch1/{{k}}"]
    params = tree("weights/")
    state = adafactor(1e-3).init(params)
    for i in range(STEPS):
        batch = {{k: z[f"batch{{i}}/{{k}}"] for k in ("tokens", "labels")}}
        with use_mesh(mesh):
            params, state, m = fn(params, state, batch)
        out[f"loss{{i}}"] = np.asarray(m["loss"])
        out[f"grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        if i == 0:
            shards("shard/param/", params)
            shards("shard/opt/", state)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params):
                out["mesh/" + pstr(path)] = np.asarray(leaf)
    # step 1 again on a (1, 1) mesh: where JAX's own two layouts part
    one = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                        axis_types=(AxisType.Auto,) * 2)
    fn, _, _ = build_jitted(cfg, one, InputShape("spmd", S, B, "train"))
    params = tree("weights/")
    batch = {{k: z[f"batch0/{{k}}"] for k in ("tokens", "labels")}}
    with use_mesh(one):
        params, _, _ = fn(params, adafactor(1e-3).init(params), batch)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out["one/" + pstr(path)] = np.asarray(leaf)
    # step 2 again, from the port's state after step 1 (its parameters and
    # Adafactor factors, which step 1's rounding noise set), once the
    # port's rank 0 has written it
    while not os.path.exists(sys.argv[3]):
        time.sleep(0.1)
    z = np.load(sys.argv[3])
    params = tree("params/")
    state = adafactor(1e-3).init(params)._replace(
        step=jax.numpy.asarray(1, jax.numpy.int32), inner=tree("inner/"))
    batch = {{k: out[f"batch1/{{k}}"] for k in ("tokens", "labels")}}
    with use_mesh(mesh):
        params, state, m = step(params, state, batch)
    out["step2/loss"] = np.asarray(m["loss"])
    out["step2/grad_norm"] = np.asarray(m["grad_norm"])
    shards("shard2/param/", params)
    shards("shard2/opt/", state)
    for k in ("tokens", "labels"):
        del out[f"batch1/{{k}}"]
    np.savez(sys.argv[2], **out)
""").format(helpers=ranks.JAX_HELPERS, arch=ranks.XLSTM_ARCH,
         layers=ranks.XLSTM_LAYERS, steps=ranks.XLSTM_STEPS)

@pytest.fixture(scope="module")
def run():
    cfg = ranks.xlstm_cfg()
    params = to_numpy_tree(causal_lm.init(
        cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
                for k in ("tokens", "labels")}
               for _ in range(ranks.XLSTM_STEPS)]
    rng = np.random.default_rng(3)
    f32 = np.float32
    B, S, nh, hd = ranks.MLSTM_SHAPE
    mlstm = {k: rng.standard_normal((B, S, nh, hd)).astype(f32)
             for k in ("q", "k", "v", "g")}
    mlstm["i_pre"] = rng.standard_normal((B, S, nh)).astype(f32)
    mlstm["f_pre"] = (rng.standard_normal((B, S, nh)) + 3.0).astype(f32)
    B, S, nh, hd = ranks.SLSTM_SHAPE
    weights = to_numpy_tree(xlstm.slstm_init(
        torch.Generator().manual_seed(4), xlstm.XLSTMCfg(nh * hd, nh)))
    weights = {k: weights[k] for k in ("w_in", "r", "b", "f_bias")}
    weights["b"] = rng.standard_normal(weights["b"].shape).astype(f32)
    slstm = {"params": weights,
             "x": rng.standard_normal((B, S, nh * hd)).astype(f32),
             "g": rng.standard_normal((B, S, nh * hd)).astype(f32)}
    return {"params": params, "batches": batches, "mlstm": mlstm,
            "slstm": slstm}


@pytest.fixture(scope="module")
def both(run, tmp_path_factory):
    """(JAX's results, the port's ranks' results): JAX's subprocess runs
    while the ranks do; its step from the port's state after step 1 waits
    for the file the port's rank 0 writes."""
    tmp = tmp_path_factory.mktemp("spmd_xlstm")
    arrays = {}
    ranks.flat_arrays(run["params"], "weights/", arrays)
    for i, b in enumerate(run["batches"]):
        for k, v in b.items():
            arrays[f"batch{i}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz"), str(tmp / "step1.npz")], env=env)
    try:
        port = spmd.run(ranks.run_xlstm_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(dict(run, step1_file=str(tmp / "step1.npz")),))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


@pytest.mark.parametrize("step", range(ranks.XLSTM_STEPS))
def test_losses_and_grad_norm_match_jax(both, step):
    """Step 1 against JAX's from the weights; step 2 against JAX's step
    from the port's state after step 1, and its loss also against JAX's
    own second step."""
    jax_run, port = both
    want = {k: jax_run[f"{k}0" if step == 0 else f"step2/{k}"]
            for k in ("loss", "grad_norm")}
    for res in port:
        got = res["train"]
        np.testing.assert_allclose(got["losses"][step], want["loss"],
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(got["grad_norms"][step],
                                   want["grad_norm"], rtol=STEP_RTOL)
        np.testing.assert_allclose(got["losses"][step],
                                   jax_run[f"loss{step}"], rtol=STEP_RTOL)


@pytest.mark.parametrize("step", range(ranks.XLSTM_STEPS))
@pytest.mark.parametrize("tree", ["param", "opt"])
def test_every_shard_matches_jax(both, tree, step):
    """Every leaf of the parameters (or of the Adafactor state) after each
    step, against JAX's step 1 from the weights and its step 2 from the
    port's state after step 1: on each mesh position the port's local
    shard has JAX's shard's shape and index, and its values within
    SHARD_ATOL; the values of the sLSTM bias ``b`` are held by the two
    tests below instead.  The sLSTM's stacked 2-D leaves
    (``groups/s/ln/scale``, the group norm) put the group axis on
    ``data``."""
    jax_run, port = both
    prefix = f"shard{'' if step == 0 else 2}/{tree}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    if tree == "param":
        assert {"groups/m/mlstm/wq", "groups/s/slstm/r",
                "groups/s/ln/scale", "tail/mlstm/up/w"} <= keys
    for rank, res in enumerate(port):
        shards = {k[len(tree) + 1:]: v
                  for k, v in res["train"]["step_shards"][step].items()
                  if k.startswith(tree + "/")}
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                ranks.index_rows(got["offset"], got["shape"]), idx), key
            if key != NOISE_LEAF:
                np.testing.assert_allclose(got["values"], want, rtol=0,
                                           atol=SHARD_ATOL, err_msg=key)


def test_jax_leaves_the_slstm_bias_update_undetermined(both):
    """JAX's own step 1 on a (1, 1) mesh against its step on the (2, 2)
    mesh: every leaf within SHARD_ATOL but the sLSTM bias ``b``, which
    parts by over 1e-3.  The cell's output does not change when a row's
    log input gates all shift alike (its normalizer ``n`` stays at 1 or
    more), so the input gate's bias has a gradient of zero in exact
    arithmetic; Adafactor divides that gradient's rounding noise by its
    own root mean square, and its leaf-wide RMS clip carries the noise
    into the other gates' rows."""
    jax_run, _ = both
    keys = [k[len("one/"):] for k in jax_run.files if k.startswith("one/")]
    assert NOISE_LEAF in keys
    for key in keys:
        gap = np.abs(jax_run["one/" + key] - jax_run["mesh/" + key]).max()
        if key == NOISE_LEAF:
            assert gap > 1e-3, gap
        else:
            assert gap <= SHARD_ATOL, (key, gap)


def test_slstm_bias_update_is_an_adafactor_step(both, run):
    """The sLSTM bias after step 1, the port's (from its ranks' shards)
    against JAX's, as ``test_torch_sharding`` holds such a leaf: the moves
    of the rows whose gradient is not noise (the z, f and o gates) agree
    up to the one scale the RMS clip sets, within 1e-4 of the largest
    move; every entry within the largest move the clip allows, lr ×
    sqrt(leaf size); and each side's update has the clipped root mean
    square, lr, no more."""
    jax_run, port = both
    init = run["params"]["groups"]["s"]["slstm"]["b"]     # (groups, 4, d)
    got = np.zeros_like(init)
    for res in port:
        sh = res["train"]["step_shards"][0]["param/" + NOISE_LEAF]
        got[tuple(slice(o, o + n) for o, n in zip(sh["offset"],
                                                  sh["shape"]))] = \
            sh["values"]
    want = jax_run["mesh/" + NOISE_LEAF]
    rows = np.ones(init.shape, dtype=bool)
    rows[:, 1] = False                                   # the input gate
    d_t, d_j = (got - init)[rows], (want - init)[rows]
    scale = float((d_t * d_j).sum() / (d_j * d_j).sum())
    assert np.abs(d_t - scale * d_j).max() <= 1e-4 * np.abs(d_j).max()
    assert np.abs(got - want).max() <= LR * np.sqrt(init.size)
    for new in (got, want):
        rms = float(np.sqrt(np.mean(np.square(new - init))))
        assert 0.0 < rms <= LR * (1 + 1e-5), rms


def test_sharded_step_equals_unsharded_step(both):
    _, port = both
    got = port[0]["train"]
    for step, rtol in enumerate((UNSHARDED_RTOL, UNSHARDED_LATER_RTOL)):
        np.testing.assert_allclose(got["losses"][step],
                                   got["unsharded_losses"][step], rtol=rtol)
    for res in port[1:]:
        assert res["train"]["losses"] == got["losses"]


def test_gathered_parameters_are_finite_and_moved(both, run):
    """The parameters gathered after the last step are finite and every
    mLSTM and sLSTM weight moved from its initial value."""
    _, port = both
    got, init = port[0]["train"]["gathered"], run["params"]
    for seg, block, names in (("groups", "m", ("up", "down")),
                              ("groups", "s", ("w_in", "ffn_down"))):
        kind = "mlstm" if block == "m" else "slstm"
        for name in names:
            w = got[seg][block][kind][name]["w"]
            assert np.isfinite(w).all()
            assert not np.array_equal(w, init[seg][block][kind][name]["w"])
    for name in ("r", "b", "f_bias"):
        assert not np.array_equal(got["groups"]["s"]["slstm"][name],
                                  init["groups"]["s"]["slstm"][name])
    for name in ("wq", "wk", "wv"):
        assert not np.array_equal(got["tail"]["mlstm"][name],
                                  init["tail"]["mlstm"][name])


def test_mlstm_parallel_sharded_equals_unsharded(both):
    """``_mlstm_parallel`` on DTensors (batch on ``data``, heads on
    ``model``) against the unsharded one on every rank: the output keeps
    rows and heads, and the gradients of q, k, v and the gates agree."""
    _, port = both
    for res in port:
        got = res["mlstm"]
        assert got["y_gap"] <= KERNEL_RTOL, got
        assert got["y_placements"] == ["S(0)", "S(2)"], got
        assert got["grad_gap"] <= KERNEL_GRAD_RTOL, got


def test_slstm_seq_sharded_equals_unsharded(both):
    """``slstm_seq`` on DTensors, its weights placed by the parameter rules,
    against the unsharded one on every rank: the head outputs (features
    on ``model``) and the final state (heads on ``model``), and the
    gradients of the input and of ``w_in``, ``r``, ``b`` and ``f_bias``."""
    _, port = both
    for res in port:
        got = res["slstm"]
        assert got["h_gap"] <= KERNEL_RTOL, got
        assert got["state_gap"] <= KERNEL_RTOL, got
        assert got["h_placements"] == ["S(0)", "S(2)"], got
        assert got["state_placements"] == ["S(0)", "S(1)"], got
        assert got["grad_gap"] <= KERNEL_GRAD_RTOL, got


def test_slstm_time_loop_has_no_collective(both):
    """The sLSTM's time loop on DTensors (``xlstm._slstm_run``) makes as
    many staged collectives at SLSTM_SHAPE's 16 steps as at SLSTM_SHORT's
    4: its weights and pre-activations are redistributed once a call, and
    none falls inside the loop (whose backward is the ranks' own, inside
    ``on_shards``)."""
    _, port = both
    S = ranks.SLSTM_SHAPE[1]
    for res in port:
        got = res["slstm"]
        assert got[f"staged_{S}"], got
        assert got[f"staged_{S}"] == got[f"staged_{ranks.SLSTM_SHORT}"], got
