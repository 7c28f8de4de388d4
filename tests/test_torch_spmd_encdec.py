"""The encoder-decoder's train step sharded over a process mesh (DTensor on
4 gloo ranks) against the JAX package's ``build_jitted`` on 4 devices, on
the CPU.

seamless-smoke cut to 2 + 2 layers with its vocabulary padded (500
classes to 512, ``torch_spmd_ranks.ENCDEC_PAD``), so the head's -1e30 mask
runs on DTensor logits.  The weights are the port's ``init`` at seed 0;
the frame embeddings (4 × 16 × 64) and the target tokens and labels (4 ×
16) come from ``numpy.random.default_rng(1)``, both made here and handed
to the two sides as numpy arrays.  JAX runs in a subprocess with 4 forced
host devices on a ``(2, 2)`` ``("data", "model")`` mesh with Auto axes,
beside one spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_encdec_ranks``): 2 Adafactor steps of
``build_jitted``'s train step, whose cross-attention runs on each rank's
rows and heads (``attention._attend_sharded``).

Tolerances, each over the gap measured here (the largest on any rank,
step or leaf): losses and ``grad_norm`` at rtol 1e-5 a step (measured:
7.6e-8 and 1.1e-7); every shard of the parameters and of the Adafactor
state after step 1 and after step 2 by mesh position, its shape and index
exact, its values at atol 1e-6 (measured: 1.2e-7, in the norm scales);
the port's own unsharded step's losses at rel 1e-6 (measured: 0).
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
from repro_torch.distributed.steps import src_len_for  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
import torch_spmd_ranks as ranks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 16
STEP_RTOL = 1e-5
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
KEYS = ("src_embeds", "tokens", "labels")
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

    ARCH, PAD, STEPS, KEYS = {arch!r}, {pad!r}, {steps}, {keys!r}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    cfg = resolve(ARCH).smoke.replace(**PAD)
    B, S = z["batch0/tokens"].shape
    fn, _, _ = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"))
    params = tree("weights/")
    state = adafactor(1e-3).init(params)
    for i in range(STEPS):
        batch = {{k: z[f"batch{{i}}/{{k}}"] for k in KEYS}}
        with use_mesh(mesh):
            params, state, m = fn(params, state, batch)
        out[f"loss{{i}}"] = np.asarray(m["loss"])
        out[f"grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        shards(f"shard{{i}}/param/", params)
        shards(f"shard{{i}}/opt/", state)
    np.savez(sys.argv[2], **out)
""").format(helpers=ranks.JAX_HELPERS, arch=ranks.ENCDEC_ARCH,
         pad=ranks.ENCDEC_PAD, steps=ranks.ENCDEC_STEPS, keys=KEYS)


@pytest.fixture(scope="module")
def run():
    cfg = ranks.encdec_cfg()
    params = to_numpy_tree(encdec.init(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    src_len = src_len_for(cfg, SEQ)
    batches = [{"src_embeds": rng.standard_normal(
                    (BATCH, src_len, cfg.d_frontend)).astype(np.float32),
                **{k: rng.integers(0, cfg.vocab, (BATCH, SEQ))
                   .astype(np.int32) for k in ("tokens", "labels")}}
               for _ in range(ranks.ENCDEC_STEPS)]
    return {"params": params, "batches": batches}


@pytest.fixture(scope="module")
def both(run, tmp_path_factory):
    """(JAX's results, the port's ranks' results): JAX's subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("spmd_encdec")
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
        port = spmd.run(ranks.run_encdec_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(run,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


def test_vocabulary_is_padded():
    """The padded variant the tests run: the head's mask has classes to
    hide."""
    cfg = ranks.encdec_cfg()
    assert cfg.family == "encdec" and cfg.vocab_padded > cfg.vocab
    assert (cfg.n_enc_layers, cfg.n_dec_layers) == (2, 2)


@pytest.mark.parametrize("step", range(ranks.ENCDEC_STEPS))
def test_losses_and_grad_norm_match_jax(both, step):
    jax_run, port = both
    for res in port:
        got = res["train"]
        np.testing.assert_allclose(got["losses"][step],
                                   jax_run[f"loss{step}"], rtol=STEP_RTOL)
        np.testing.assert_allclose(got["grad_norms"][step],
                                   jax_run[f"grad_norm{step}"],
                                   rtol=STEP_RTOL)


@pytest.mark.parametrize("step", range(ranks.ENCDEC_STEPS))
@pytest.mark.parametrize("tree", ["param", "opt"])
def test_every_shard_matches_jax(both, tree, step):
    """Every leaf of the parameters (or of the Adafactor state) after each
    step: on each mesh position the port's local shard has JAX's shard's
    shape and index, and its values within SHARD_ATOL.  The encoder's and
    decoder's stacks, the source projection, the embedding and the padded
    head are all there."""
    jax_run, port = both
    prefix = f"shard{step}/{tree}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    if tree == "param":
        assert {"src_proj/w", "embed/table", "head/w", "enc/attn/wq/w",
                "dec/cross_attn/wk/w", "dec/ln_x/scale"} <= keys
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
    """The parameters gathered after the last step are finite, and the
    source projection, both stacks' attention and MLP weights, the
    cross-attention's and the head moved from their initial values."""
    _, port = both
    got, init = port[0]["train"]["gathered"], run["params"]
    for path in (("src_proj", "w"), ("enc", "attn", "wq", "w"),
                 ("enc", "mlp", "up", "w"), ("dec", "self_attn", "wo", "w"),
                 ("dec", "cross_attn", "wk", "w"),
                 ("dec", "cross_attn", "wv", "w"), ("head", "w")):
        g, w = got, init
        for part in path:
            g, w = g[part], w[part]
        assert np.isfinite(g).all(), path
        assert not np.array_equal(g, w), path


def test_the_step_stages_collectives(both):
    """The ranks' steps ran sharded: every rank staged collectives."""
    _, port = both
    for res in port:
        assert sum(v for k, v in res["staged"].items()
                   if k.endswith("_calls")) > 0
