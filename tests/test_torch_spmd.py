"""The gspmd train step sharded over a process mesh (DTensor on 4 gloo
ranks) against the JAX package's ``build_jitted`` on 4 devices, on the CPU.

JAX runs once, in a subprocess with 4 forced host devices, on a ``(2, 2)``
``("data", "model")`` mesh with Auto axes (jax 0.9's ``jax.make_mesh``
makes Explicit ones, on which the step fails at the embedding gather:
ROADMAP Queue 3): 2 Adafactor steps of ``build_jitted``'s step for
gpt2-xl, llama3-8b and internvl2-2b (the vlm: 8 patch embeddings
projected ahead of 8 text tokens) at smoke size (batch 4 × 16,
``PRNGKey(0)``), under ``use_mesh``; it saves the weights, the batches,
the losses, ``grad_norm`` and every leaf's ``addressable_shards`` (mesh
position, index, values), and ``devices_indices_map`` for every
placement case.
The port's 4 ranks (``launch.spmd``, the host-staged group, one spawn for
the module: ``torch_spmd_ranks.run_ranks``) load the same weights and take
the same steps.

Tolerances: losses and ``grad_norm`` at rtol 1e-4 a step, as
``test_torch_gspmd`` holds the unsharded step; every shard's values at
atol 1e-6; the sharded loss against the port's own unsharded step at rel
1e-6 (the sums run in another order: 8e-8 is the largest gap seen here).
The placements are exact.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import sharding as t_sh  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
import torch_spmd_ranks as ranks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("gpt2-xl", "llama3-8b", "internvl2-2b")
BATCH_KEYS = ("tokens", "labels", "prefix_embeds")
STEPS, BATCH = 2, 4
STEP_RTOL = 1e-4
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
TIMEOUT = 240

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import resolve
    from repro.configs.base import InputShape
    from repro.distributed import params as jp
    from repro.distributed.sharding import use_mesh
    from repro.distributed.steps import build_jitted
    from repro.models import causal_lm
    from repro.optim import adafactor

    ARCHS, STEPS, B, S = {archs!r}, {steps}, {batch}, {seq}
    MESHES, CASES = {meshes!r}, {cases!r}
    out = {{}}

    def mesh_of(shape, axes):
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    def pstr(path):
        return "/".join(str(getattr(p, "key", getattr(p, "name",
                                                     getattr(p, "idx", p))))
                        for p in path)

    def index(idx, shape):
        return np.array([[s.start or 0, d if s.stop is None else s.stop]
                         for s, d in zip(idx, shape)],
                        dtype=np.int64).reshape(-1, 2)

    def spec(mesh, rule, shape):
        if rule == "batch_spec":
            sp = list(jp.batch_spec(shape[0], mesh))
            sp += [None] * (len(shape) - len(sp))
            return jp.P(*sp[:len(shape)])
        return getattr(jp, rule)(shape, mesh)

    meshes = {{n: mesh_of(*m) for n, m in MESHES.items()}}
    for cid, mname, rule, shape in CASES:
        mesh = meshes[mname]
        pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}
        sh = NamedSharding(mesh, spec(mesh, rule, shape))
        for dev, idx in sh.devices_indices_map(shape).items():
            out[f"case/{{cid}}@{{pos[dev.id]}}"] = index(idx, shape)
        out[f"spec/{{cid}}"] = np.array(repr(tuple(sh.spec)))

    mesh = meshes["2x2"]
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    def shards(prefix, tree):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = prefix + pstr(path)
            for s in leaf.addressable_shards:
                i = pos[s.device.id]
                out[f"{{key}}@{{i}}"] = np.asarray(s.data)
                out[f"{{key}}@{{i}}#index"] = index(s.index, leaf.shape)

    for arch in ARCHS:
        cfg = resolve(arch).smoke
        fn, _, _ = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"))
        params = causal_lm.init(cfg, jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            out[f"{{arch}}/weights/{{pstr(path)}}"] = np.asarray(leaf)
        state = adafactor(1e-3).init(params)
        rng = np.random.default_rng(1)
        for i in range(STEPS):
            batch = {{k: rng.integers(0, cfg.vocab, (B, S - cfg.n_prefix))
                     .astype(np.int32) for k in ("tokens", "labels")}}
            if cfg.n_prefix:
                batch["prefix_embeds"] = rng.standard_normal(
                    (B, cfg.n_prefix, cfg.d_frontend)).astype(np.float32)
            for k, v in batch.items():
                out[f"{{arch}}/batch{{i}}/{{k}}"] = v
            with use_mesh(mesh):
                params, state, m = fn(params, state, batch)
            out[f"{{arch}}/loss{{i}}"] = np.asarray(m["loss"])
            out[f"{{arch}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        shards(f"{{arch}}/shard/param/", params)
        shards(f"{{arch}}/shard/opt/", state)
    np.savez(sys.argv[1], **out)
""").format(archs=ARCHS, steps=STEPS, batch=BATCH, seq=ranks.SEQ,
            meshes=ranks.MESHES, cases=ranks.cases())


def _tree(z, prefix):
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
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("spmd_jax") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", SCRIPT, str(out)], env=env,
                   check=True, timeout=TIMEOUT)
    return np.load(out)


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    runs = {arch: {"params": _tree(jax_run, f"{arch}/weights/"),
                   "batches": [{k: jax_run[f"{arch}/batch{i}/{k}"]
                                for k in BATCH_KEYS
                                if f"{arch}/batch{i}/{k}" in jax_run.files}
                               for i in range(STEPS)]}
            for arch in ARCHS}
    rdv = str(tmp_path_factory.mktemp("spmd_rdv"))
    return spmd.run(ranks.run_ranks, 4, rdv_dir=rdv, device="cpu",
                    backend=spmd.STAGED, timeout=TIMEOUT, args=(runs,))


def _index(offset, local_shape):
    return np.array([[o, o + n] for o, n in zip(offset, local_shape)],
                    dtype=np.int64).reshape(-1, 2)


@pytest.mark.parametrize("cid,mesh,rule,shape", ranks.cases(),
                         ids=[c[0] for c in ranks.cases()])
def test_placements_equal_jax_devices_indices_map(jax_run, port_run, cid,
                                                  mesh, rule, shape):
    """DTensor's own shard of each rank, placed by the port's
    ``NamedSharding.placements``, is JAX's ``devices_indices_map`` entry
    for that mesh position, and its values are that slice of the whole."""
    assert repr(port_run[0]["placements"][cid]["spec"]) == \
        str(jax_run[f"spec/{cid}"])
    full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    for rank, res in enumerate(port_run):
        got = res["placements"][cid]
        want = jax_run[f"case/{cid}@{rank}"]
        assert np.array_equal(_index(got["offset"], got["shape"]),
                              want), (rank, got["offset"], got["shape"])
        sl = tuple(slice(a, b) for a, b in want)
        assert np.array_equal(got["values"], full[sl])


def test_constrain_on_a_process_mesh(port_run):
    from torch.distributed.tensor import Replicate, Shard
    for res in port_run:
        c = res["constrain"]
        assert c["local_mesh"] == (4, 1)
        for axes in (("batch", "model"), ("batch", None), (None, "vocab")):
            assert c[axes]["placements"] == c[axes]["want"]
            assert c[axes]["same_values"]
        assert c[("batch", "model")]["placements"] == \
            [str(Shard(0)), str(Shard(1))]
        # an all-None spec is the identity, as in JAX
        assert c[("seq", "act_seq")]["placements"] == [str(Replicate())] * 2
        assert c["plain"].startswith("TypeError")


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_grad_norm_match_jax(jax_run, port_run, arch):
    for res in port_run:
        got = res["train"][arch]
        for i in range(STEPS):
            np.testing.assert_allclose(got["losses"][i],
                                       jax_run[f"{arch}/loss{i}"],
                                       rtol=STEP_RTOL)
            np.testing.assert_allclose(got["grad_norms"][i],
                                       jax_run[f"{arch}/grad_norm{i}"],
                                       rtol=STEP_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_shard_matches_jax(jax_run, port_run, arch):
    """Every leaf of the parameters and the Adafactor state after the last
    step: on each mesh position the port's local shard has JAX's shard's
    shape and index, and its values within SHARD_ATOL."""
    prefix = f"{arch}/shard/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    for rank, res in enumerate(port_run):
        shards = res["train"][arch]["shards"]
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                _index(got["offset"], got["shape"]), idx), key
            np.testing.assert_allclose(got["values"], want, rtol=0,
                                       atol=SHARD_ATOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_unsharded_step(port_run, arch):
    got = port_run[0]["train"][arch]
    np.testing.assert_allclose(got["losses"], got["unsharded_losses"],
                               rtol=UNSHARDED_RTOL)
    # every rank saw the same replicated loss
    for res in port_run[1:]:
        assert res["train"][arch]["losses"] == got["losses"]


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_parameters_are_the_shards(port_run, arch):
    """``to_numpy_tree`` gathers each DTensor whole: the gathered tree holds
    every rank's shard at its index."""
    gathered = port_run[0]["train"][arch]["gathered"]
    for res in port_run:
        for key, got in res["train"][arch]["shards"].items():
            if not key.startswith("param/"):
                continue
            leaf = gathered
            for part in key[len("param/"):].split("/"):
                leaf = leaf[part]
            sl = tuple(slice(o, o + n) for o, n in zip(got["offset"],
                                                        got["shape"]))
            assert np.array_equal(leaf[sl], got["values"]), key


def test_adamw_step_sharded_equals_unsharded(port_run):
    """AdamW's moments are placed by ``generic_spec`` and its step counter
    replicated; one sharded step against the unsharded one, shard for
    shard: the moments within SHARD_ATOL, the parameters as
    ``test_torch_gspmd`` holds AdamW's (at most 1e-4 of the entries off
    atol 1e-6 + rtol 1e-4, all within two steps of the learning rate: the
    first update is g / (|g| + 1e-8), so an entry whose gradient is at the
    rounding level of its sum moves by another fraction of the rate when
    the sum runs in another order)."""
    for res in port_run:
        got = res["adamw"]
        assert got["step"] == 1
        np.testing.assert_allclose(got["loss"], got["unsharded_loss"],
                                   rtol=UNSHARDED_RTOL)
        worst, off, n = got["params_gap"]
        assert off <= 1e-4 * n and worst <= 2 * got["lr"]
        assert got["moments_gap"][0] <= SHARD_ATOL


def test_staged_group_carried_the_collectives(port_run):
    """The ranks ran on the host-staged group: its counts name every kind
    of collective the step redistributes with."""
    for res in port_run:
        staged = res["staged"]
        for kind in ("all_gather", "all_reduce", "reduce_scatter"):
            assert staged[f"{kind}_calls"] > 0
            assert staged[f"{kind}_bytes"] > 0


def test_a_failing_rank_raises_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        spmd.run(ranks.fail_on_rank_1, 2, rdv_dir=str(tmp_path),
                 device="cpu", backend="gloo", timeout=60)
    assert "rank 1 stops here" in str(err.value)


def test_process_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_process_mesh((2, 2), ("data", "model"), "cpu")
    mesh = make_local_mesh("cpu")
    assert tuple(mesh.shape.values()) == (1, 1)
    assert not mesh.is_process_mesh


def test_placements_of_specs_without_a_group():
    """``NamedSharding.placements`` and ``local_slices`` are pure: a tuple
    entry shards one dimension on each of its axes, major first."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t_sh.Mesh((1, 2, 2), ("pod", "data", "model"))
    sh = t_sh.NamedSharding(mesh, t_sh.P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert t_sh.NamedSharding(mesh, t_sh.P()).placements == \
        (Replicate(),) * 3
    assert sh.local_slices((4, 3, 8), {"pod": 0, "data": 1, "model": 1}) \
        == (slice(2, 4), slice(None), slice(4, 8))
    with pytest.raises(NotImplementedError, match="axis order"):
        t_sh.NamedSharding(mesh, t_sh.P(("data", "pod"))).placements
