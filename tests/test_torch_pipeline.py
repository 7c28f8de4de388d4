"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) against
the JAX package's ``shard_map`` pipeline, on the CPU.

The JAX pipeline needs eight devices, so it runs once in a subprocess with
eight forced host devices (the test process keeps one), at the reference
test's sizes: gpt2-smoke with 8 layers, batch 8 × seq 32, 4 micro-batches.
It writes its weights, batch, losses and gradients (taken under
``jax.set_mesh``, which jax 0.9 needs to differentiate the program) to an
npz; the port loads the same weights with ``from_numpy_tree`` and runs its
pipeline on meshes whose eight positions are the CPU.

Tolerances: the loss within rel 1e-6 uncompressed and rtol 1e-5
compressed; the gradients leaf by leaf, max |port - JAX| within 1e-5 of
the leaf's max |JAX|, and as one vector within rel 1e-5 (on this CPU the
worst leaf is at 1.7e-6 and no compressed case falls on a tie group: both
packages keep the same entries at every boundary).  One AdamW step through
``make_pipeline_train_step`` is held as ``test_torch_gspmd`` holds AdamW.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import resolve as j_resolve  # noqa: E402
from repro.distributed import pipeline as j_pipe  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.distributed import pipeline as t_pipe  # noqa: E402
from repro_torch.distributed.sharding import Mesh  # noqa: E402
from repro_torch.distributed.steps import value_and_grad  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_gspmd import _assert_adamw_params_close  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N_MICRO = 4
LR = 3e-4
# (name, mesh shape, axes, base_ratio, use_kernel)
CASES = [("model8", (8,), ("model",), 1.0, False),
         ("pod_r1_global", (2, 4), ("pod", "model"), 1.0, False),
         ("pod_r10_global", (2, 4), ("pod", "model"), 10.0, False),
         ("pod_r1_auto", (2, 4), ("pod", "model"), 1.0, "auto"),
         ("pod_r10_auto", (2, 4), ("pod", "model"), 10.0, "auto")]
COMPRESSED = [c for c in CASES if c[1] == (2, 4)]

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from repro.configs import resolve
    from repro.distributed.pipeline import (make_pipeline_train_fn,
                                            make_pipeline_train_step,
                                            microbatch)
    from repro.models import causal_lm
    from repro.optim import adamw

    CASES, N_MICRO, LR = {cases!r}, {n_micro}, {lr}

    def flat(prefix, tree):
        return {{prefix + "/".join(str(p.key) for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}}

    cfg = resolve("gpt2-xl").smoke.replace(n_layers=8, max_seq=32)
    params = causal_lm.init(cfg, jax.random.PRNGKey(0))
    kt, kl = jax.random.split(jax.random.PRNGKey(1))
    batch = {{"tokens": jax.random.randint(kt, (8, 32), 0, cfg.vocab),
             "labels": jax.random.randint(kl, (8, 32), 0, cfg.vocab)}}
    mb = microbatch(batch, N_MICRO)
    out = flat("param/", params)
    out.update(tokens=np.asarray(batch["tokens"]),
               labels=np.asarray(batch["labels"]),
               train_loss=np.asarray(causal_lm.train_loss(cfg, params,
                                                          batch)[0]))
    for name, shape, axes, ratio, kern in CASES:
        mesh = jax.make_mesh(shape, axes)
        fn = make_pipeline_train_fn(cfg, mesh, N_MICRO, ratio,
                                    use_kernel=kern)
        with jax.set_mesh(mesh):
            loss, g = jax.value_and_grad(lambda p: fn(p, mb))(params)
        out["loss/" + name] = np.asarray(loss)
        out.update(flat("grad/" + name + "/", g))
    # one AdamW step: the pod mesh at base_ratio 10
    mesh = jax.make_mesh((2, 4), ("pod", "model"))
    opt = adamw(LR)
    step = make_pipeline_train_step(cfg, mesh, opt, N_MICRO, 10.0)
    with jax.set_mesh(mesh):
        new, _, m = step(params, opt.init(params), mb)
    out["step/loss"] = np.asarray(m["loss"])
    out.update(flat("step/param/", new))
    # a padded vocabulary (500 classes padded to 512, the same shapes)
    cfg_pad = cfg.replace(vocab=500, vocab_pad_to=256)
    bp = {{k: v % 500 for k, v in batch.items()}}
    mesh = jax.make_mesh((8,), ("model",))
    with jax.set_mesh(mesh):
        out["pad/pipeline_loss"] = np.asarray(make_pipeline_train_fn(
            cfg_pad, mesh, N_MICRO)(params, microbatch(bp, N_MICRO)))
    out["pad/train_loss"] = np.asarray(causal_lm.train_loss(cfg_pad, params,
                                                            bp)[0])
    np.savez(sys.argv[1], **out)
""").format(cases=CASES, n_micro=N_MICRO, lr=LR)


def _unflat(z, prefix):
    tree = {}
    for key in z.files:
        if key.startswith(prefix):
            *parts, last = key[len(prefix):].split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = z[key]
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX pipeline's run (about 30 s in its subprocess)."""
    path = tmp_path_factory.mktemp("pipeline") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(path)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    z = np.load(path)
    return {"z": z, "params": from_numpy_tree(_unflat(z, "param/"), CPU),
            "batch": {k: torch.from_numpy(z[k]) for k in ("tokens",
                                                          "labels")}}


def _cfg():
    return t_resolve("gpt2-xl").smoke.replace(n_layers=8, max_seq=32)


def _mesh(shape, axes):
    return make_mesh(shape, axes, [CPU] * 8)


def _leaves(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{key}/")
        else:
            yield prefix + key, v


def _assert_grads_close(t_tree, j_tree):
    t = {k: v.detach().numpy() for k, v in _leaves(t_tree)}
    j = dict(_leaves(j_tree))
    assert t.keys() == j.keys()
    num = den = 0.0
    for key, b in j.items():
        a = t[key]
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), key
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    assert num <= (1e-5) ** 2 * den


def _run(ref, shape, axes, ratio, kern):
    fn = t_pipe.make_pipeline_train_fn(_cfg(), _mesh(shape, axes), N_MICRO,
                                       ratio, use_kernel=kern)
    mb = t_pipe.microbatch(ref["batch"], N_MICRO)
    return value_and_grad(lambda p: fn(p, mb), ref["params"])


def test_uncompressed_pipeline_matches_jax_and_train_loss(ref):
    """On the ``(8,)`` model mesh nothing is compressed: the loss is the
    model's loss (JAX's ``train_loss`` and the JAX pipeline's), and the
    gradients the JAX pipeline's."""
    name, shape, axes, ratio, kern = CASES[0]
    loss, grads = _run(ref, shape, axes, ratio, kern)
    z = ref["z"]
    for want in (z["loss/" + name], z["train_loss"]):
        assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    _assert_grads_close(grads, _unflat(z, f"grad/{name}/"))


@pytest.mark.parametrize("name,shape,axes,ratio,kern", COMPRESSED,
                         ids=[c[0] for c in COMPRESSED])
def test_compressed_pipeline_matches_jax(ref, name, shape, axes, ratio, kern):
    """The ``(2, 4)`` pod mesh compresses edge 3 -> 4 at ratio 3r: global
    Top-K (``use_kernel=False``) or the blockwise codec (``"auto"``: the
    plain versions of the CUDA kernels here, JAX's XLA codec there)."""
    loss, grads = _run(ref, shape, axes, ratio, kern)
    want = float(ref["z"]["loss/" + name])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert float(loss) != float(ref["z"]["train_loss"])  # it compressed
    _assert_grads_close(grads, _unflat(ref["z"], f"grad/{name}/"))


def test_pipeline_train_step_matches_jax(ref):
    cfg = _cfg()
    mesh = _mesh((2, 4), ("pod", "model"))
    opt = adamw(LR)
    step = t_pipe.make_pipeline_train_step(cfg, mesh, opt, N_MICRO, 10.0)
    new, state, m = step(ref["params"], opt.init(ref["params"]),
                         t_pipe.microbatch(ref["batch"], N_MICRO))
    want = float(ref["z"]["step/loss"])
    assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want)
    assert int(state.step) == 1
    _assert_adamw_params_close(new, _unflat(ref["z"], "step/param/"), LR)


def test_padded_vocab_head_is_the_models(ref):
    """The port's head masks the padded classes, as ``causal_lm`` does, so
    its pipeline loss is the model's; the JAX pipeline's head keeps them in
    the softmax (``repro/distributed/pipeline.py`` ``head_loss``) and its
    loss is another number."""
    cfg = _cfg().replace(vocab=500, vocab_pad_to=256)
    bp = {k: v % 500 for k, v in ref["batch"].items()}
    fn = t_pipe.make_pipeline_train_fn(cfg, _mesh((8,), ("model",)), N_MICRO)
    loss = float(fn(ref["params"], t_pipe.microbatch(bp, N_MICRO)))
    z = ref["z"]
    assert abs(loss - float(z["pad/train_loss"])) <= \
        1e-6 * float(z["pad/train_loss"])
    assert abs(float(z["pad/pipeline_loss"]) - loss) > 1e-3


MESHES = [((8,), ("model",)), ((2, 4), ("pod", "model")),
          ((4, 4), ("pod", "model")), ((2, 4), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model")), ((1, 8), ("pod", "model"))]


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("base_ratio", [0.2, 1.0, 10.0, 33.3])
def test_stage_layout_and_edge_ratios_match_jax(shape, axes, base_ratio):
    jm = AbstractMesh(shape, axes)
    tm = make_mesh(shape, axes, [CPU] * int(np.prod(shape)))
    assert t_pipe.stage_axes(tm) == j_pipe.stage_axes(jm)
    assert t_pipe.n_stages(tm) == j_pipe.n_stages(jm)
    r_t = t_pipe.pod_edge_ratios(tm, base_ratio)
    r_j = j_pipe.pod_edge_ratios(jm, base_ratio)
    assert r_t.dtype == r_j.dtype and np.array_equal(r_t, r_j)
    assert np.array_equal(t_pipe.pod_edge_ratios(tm, base_ratio, 2.0),
                          j_pipe.pod_edge_ratios(jm, base_ratio, 2.0))


def test_stage_devices_follow_the_stage_axes():
    devs = [torch.device("cuda", i) for i in range(8)]
    pod = make_mesh((2, 4), ("pod", "model"), devs)
    assert t_pipe.stage_devices(pod) == devs
    dm = make_mesh((2, 4), ("data", "model"), devs)
    assert t_pipe.stage_devices(dm) == devs[:4]      # data replica 0
    with pytest.raises(ValueError, match="with devices"):
        t_pipe.stage_devices(Mesh((2, 4), ("pod", "model")))


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8, 3])
def test_microbatch_matches_jax(n_micro):
    rng = np.random.default_rng(n_micro)
    batch = {"tokens": rng.integers(0, 100, (8, 5)),
             "x": rng.standard_normal((8, 3, 2)).astype(np.float32)}
    if 8 % n_micro:
        for fn, conv in ((t_pipe.microbatch, torch.from_numpy),
                         (j_pipe.microbatch, jnp.asarray)):
            with pytest.raises(ValueError, match="not divisible"):
                fn({k: conv(v) for k, v in batch.items()}, n_micro)
        return
    t = t_pipe.microbatch({k: torch.from_numpy(v) for k, v in batch.items()},
                          n_micro)
    j = j_pipe.microbatch({k: jnp.asarray(v) for k, v in batch.items()},
                          n_micro)
    for k in batch:
        assert np.array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b", "xlstm-1_3b",
                                  "seamless-m4t-large-v2", "internvl2-2b"])
def test_non_dense_family_raises_as_in_jax(arch):
    with pytest.raises(NotImplementedError):
        j_pipe.make_pipeline_train_fn(j_resolve(arch).smoke,
                                      AbstractMesh((8,), ("model",)), 4)
    with pytest.raises(NotImplementedError):
        t_pipe.make_pipeline_train_fn(t_resolve(arch).smoke,
                                      _mesh((8,), ("model",)), 4)


def test_layers_must_divide_into_stages():
    cfg = _cfg().replace(n_layers=6)
    params = {"blocks": {"w": torch.zeros(6, 2)}}
    with pytest.raises(ValueError, match="not divisible"):
        t_pipe._split_stage_params(cfg, params, 4)
    blocks, rest = t_pipe._split_stage_params(cfg, params, 3)
    assert blocks["w"].shape == (3, 2, 2) and rest == {}
    assert to_numpy_tree(blocks)["w"].shape == \
        np.asarray(j_pipe._split_stage_params(
            cfg, {"blocks": {"w": jnp.zeros((6, 2))}}, 3)[0]["w"]).shape
