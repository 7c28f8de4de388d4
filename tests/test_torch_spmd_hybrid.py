"""The hybrid family's train step sharded over a process mesh (DTensor on 4
gloo ranks) against the JAX package's ``build_jitted`` on 4 devices, on
the CPU.

zamba2-smoke cut to 7 layers: 3 groups of 2 Mamba2 blocks, each followed
by shared attention block ``g % 2`` (so block 0 serves two groups and its
gradient sums over both), and a 1-layer Mamba2 tail.  The weights are the
port's ``init`` at seed 0 and the batches come from
``numpy.random.default_rng(1)``, both made here and handed to the two
sides as numpy arrays.  4 × 16 tokens span two SSD chunks of 8, so the
inter-chunk state is not zero.  JAX runs in a subprocess with 4 forced
host devices on a ``(2, 2)`` ``("data", "model")`` mesh with Auto axes,
beside one spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_hybrid_ranks``): 2 Adafactor steps of
``build_jitted``'s train step.  The same ranks run ``ssd_chunked`` alone on
DTensors (batch on ``data``, heads on ``model``), so that a fault of the
SSD shows apart from the rest of the model.

Tolerances: losses and ``grad_norm`` at rtol 1e-4 a step, as the other
spmd files hold them; every shard's values at atol 1e-6 by mesh position,
its shape and index exact; the sharded loss against the port's own
unsharded step at rel 1e-6; the sharded SSD's output and final state
against the unsharded ``ssd_chunked`` at rel 1e-6 of their largest
magnitude.  A 3-layer cut (one group, so the second shared block is
unused) holds its loss at rel 1e-6 and its gradients, as one vector, at
rel 1e-5: they are 1.66e-6 from the unsharded ones (the rows' partial
sums of the weight gradients add up in another order than one device's
sum).
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
from repro_torch.models import causal_lm  # noqa: E402
import torch_spmd_ranks as ranks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 16
STEP_RTOL = 1e-4
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
SSD_RTOL = 1e-6
ONE_GROUP_GRAD_RTOL = 1e-5
TIMEOUT = 240

SCRIPT = textwrap.dedent("""
    import os, sys
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
    params = tree("weights/")
    state = adafactor(1e-3).init(params)
    for i in range(STEPS):
        batch = {{k: z[f"batch{{i}}/{{k}}"] for k in ("tokens", "labels")}}
        with use_mesh(mesh):
            params, state, m = fn(params, state, batch)
        out[f"loss{{i}}"] = np.asarray(m["loss"])
        out[f"grad_norm{{i}}"] = np.asarray(m["grad_norm"])
    shards("shard/param/", params)
    shards("shard/opt/", state)
    np.savez(sys.argv[2], **out)
""").format(helpers=ranks.JAX_HELPERS, arch=ranks.HYBRID_ARCH,
         layers=ranks.HYBRID_LAYERS, steps=ranks.HYBRID_STEPS)


@pytest.fixture(scope="module")
def run():
    cfg = ranks.hybrid_cfg()
    params = to_numpy_tree(causal_lm.init(
        cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
                for k in ("tokens", "labels")}
               for _ in range(ranks.HYBRID_STEPS)]
    B, S, nh, hd, ds = ranks.SSD_SHAPE
    rng = np.random.default_rng(3)
    f32 = np.float32
    ssd = {"x": rng.standard_normal((B, S, nh, hd)).astype(f32),
           "dt": rng.uniform(1e-3, 0.1, (B, S, nh)).astype(f32),
           "A": -np.exp(np.linspace(0.0, np.log(16.0), nh)).astype(f32),
           "Bm": rng.standard_normal((B, S, ds)).astype(f32),
           "Cm": rng.standard_normal((B, S, ds)).astype(f32),
           "D": rng.standard_normal(nh).astype(f32)}
    return {"params": params, "batches": batches, "ssd": ssd}


@pytest.fixture(scope="module")
def both(run, tmp_path_factory):
    """(JAX's results, the port's ranks' results): JAX's subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("spmd_hybrid")
    arrays = {}
    ranks.flat_arrays(run["params"], "weights/", arrays)
    for i, b in enumerate(run["batches"]):
        for k, v in b.items():
            arrays[f"batch{i}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_hybrid_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(run,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


@pytest.mark.parametrize("step", range(ranks.HYBRID_STEPS))
def test_losses_and_grad_norm_match_jax(both, step):
    jax_run, port = both
    for res in port:
        got = res["train"]
        np.testing.assert_allclose(got["losses"][step],
                                   jax_run[f"loss{step}"], rtol=STEP_RTOL)
        np.testing.assert_allclose(got["grad_norms"][step],
                                   jax_run[f"grad_norm{step}"],
                                   rtol=STEP_RTOL)


@pytest.mark.parametrize("tree", ["param", "opt"])
def test_every_shard_matches_jax(both, tree):
    """Every leaf of the parameters (or of the Adafactor state) after the
    last step: on each mesh position the port's local shard has JAX's
    shard's shape and index, and its values within SHARD_ATOL.  The
    stacked Mamba2 weights (groups, 2, ...) put the pair on ``data``, the
    conv taps on ``data`` and the channels on ``model``."""
    jax_run, port = both
    prefix = f"shard/{tree}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    if tree == "param":
        assert {"groups/mamba/in_proj/w", "groups/mamba/conv/w",
                "tail/ln/scale", "shared_attn/attn/wq/w"} <= keys
    for rank, res in enumerate(port):
        shards = {k[len(tree) + 1:]: v
                  for k, v in res["train"]["shards"].items()
                  if k.startswith(tree + "/")}
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                ranks.index_rows(got["offset"], got["shape"]), idx), key
            np.testing.assert_allclose(got["values"], want, rtol=0,
                                       atol=SHARD_ATOL, err_msg=key)


def test_sharded_step_equals_unsharded_step(both):
    _, port = both
    got = port[0]["train"]
    np.testing.assert_allclose(got["losses"], got["unsharded_losses"],
                               rtol=UNSHARDED_RTOL)
    for res in port[1:]:
        assert res["train"]["losses"] == got["losses"]


def test_gathered_parameters_are_finite_and_moved(both, run):
    """The parameters gathered after the last step are finite and every
    Mamba2 and shared-attention weight moved from its initial value."""
    _, port = both
    got, init = port[0]["train"]["gathered"], run["params"]
    for seg in ("groups", "tail"):
        for name in ("in_proj", "out_proj"):
            w = got[seg]["mamba"][name]["w"]
            assert np.isfinite(w).all()
            assert not np.array_equal(w, init[seg]["mamba"][name]["w"])
    for g in range(2):                  # both shared blocks trained
        w = got["shared_attn"]["attn"]["wq"]["w"][g]
        assert not np.array_equal(w, init["shared_attn"]["attn"]["wq"]["w"][g])


@pytest.mark.parametrize("out", ["y", "h"])
def test_ssd_chunked_sharded_equals_unsharded(both, out):
    """``ssd_chunked`` on DTensors (heads on ``model``) against the
    unsharded ``ssd_chunked``, on every rank; the output keeps the heads
    on ``model`` and the final state comes back in fp32, placed alike."""
    _, port = both
    for res in port:
        got = res["ssd"]
        assert got[f"{out}_gap"] <= SSD_RTOL, got
        assert got[f"{out}_placements"] == ["S(0)", {"y": "S(2)",
                                                     "h": "S(1)"}[out]]
        assert got["h_dtype"] == "torch.float32"


def test_one_group_leaves_a_shared_block_unused(both):
    """zamba2-smoke cut to 3 layers runs one group, so shared block 1 is
    unused: on DTensors its gradient is zero (as JAX's is), and the loss
    and the gradients (one vector) equal the unsharded ones."""
    _, port = both
    for res in port:
        got = res["one_group"]
        assert got["unused_block_max_grad"] == 0.0, got
        assert got["loss_gap"] <= UNSHARDED_RTOL, got
        assert got["grad_gap"] <= ONE_GROUP_GRAD_RTOL, got

