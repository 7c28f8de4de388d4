"""The prefill and decode steps sharded over a process mesh (DTensor on 4
gloo ranks) against the JAX package's ``build_jitted`` on 4 devices, on
the CPU.

For gpt2-smoke (learned positions, 4 KV heads), llama3-smoke (RoPE, GQA),
internvl2-smoke (the vlm: 8 patch embeddings projected ahead of the
prompt) and mixtral-smoke (``moe_impl="capacity"``): the port's ``init``
at seed 0, a prompt of 4 × 16 tokens (and the vlm's patch embeddings)
and 4 decode steps' tokens from ``numpy.random.default_rng(2)``, made
here and handed to both sides.  JAX
runs ``build_jitted``'s jitted prefill (a 32-slot cache out on
``cache_shardings``) and decode steps (the cache in and out on them) in a
subprocess with 4 forced host devices on a ``(2, 2)`` ``("data",
"model")`` mesh with Auto axes, beside one spawn of the port's 4 ranks on
the host-staged group (``torch_spmd_ranks.run_serve_ranks``).  The KV
caches are sharded over batch on ``data`` and head_dim on ``model``.

Tolerances: the logits of the prefill and of every decode step at rtol
1e-5, atol 1e-6; every shard of the cache after the prefill and after the
last step by mesh position, its shape and index exact, its values at
rtol 1e-5, atol 1e-5, as ``test_torch_decode`` holds the caches: keys and
values of unit scale deep in the stack differ by the frameworks'
summation orders (here the port's unsharded cache is 2.7e-6 to 3.2e-6
from JAX's, and the sharded one 2.2e-6 to 3.1e-6, both over the atol
1e-6 the logits take); the port's own unsharded steps at the same
tolerances.
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
ARCHS = ranks.SERVE_ARCHS
BATCH = 4
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
CACHE_RTOL, CACHE_ATOL = 1e-5, 1e-5
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

    ARCHS, L = {archs!r}, {cache_len}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    for arch in ARCHS:
        cfg = resolve(arch).smoke
        if cfg.family == "moe":
            cfg = cfg.replace(moe_impl="capacity")
        prompt = z[f"{{arch}}/prompt"]
        B = prompt.shape[0]
        pf, _, _ = build_jitted(cfg, mesh, InputShape("p", L, B, "prefill"))
        df, _, _ = build_jitted(cfg, mesh, InputShape("d", L, B, "decode"))
        params = tree(f"{{arch}}/weights/")
        batch = {{"tokens": prompt}}
        if f"{{arch}}/prefix" in z.files:
            batch["prefix_embeds"] = z[f"{{arch}}/prefix"]
        with use_mesh(mesh):
            logits, cache = pf(params, batch)
        out[f"{{arch}}/logits0"] = np.asarray(logits)
        shards(f"{{arch}}/prefill_cache/", cache)
        for i, t in enumerate(z[f"{{arch}}/tokens"]):
            with use_mesh(mesh):
                logits, cache = df(params, cache, t)
            out[f"{{arch}}/logits{{i + 1}}"] = np.asarray(logits)
        shards(f"{{arch}}/cache/", cache)
    np.savez(sys.argv[2], **out)
""").format(helpers=ranks.JAX_HELPERS, archs=ARCHS,
         cache_len=ranks.CACHE_LEN)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for arch in ARCHS:
        cfg = ranks.smoke_cfg(arch)
        rng = np.random.default_rng(2)
        out[arch] = {
            "params": to_numpy_tree(causal_lm.init(
                cfg, torch.Generator().manual_seed(0))),
            "prompt": rng.integers(0, cfg.vocab, (BATCH, ranks.PROMPT))
            .astype(np.int32),
            "tokens": rng.integers(0, cfg.vocab,
                                   (ranks.DECODE_STEPS, BATCH, 1))
            .astype(np.int32)}
        if cfg.n_prefix:
            out[arch]["prefix"] = rng.standard_normal(
                (BATCH, cfg.n_prefix, cfg.d_frontend)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def both(runs, tmp_path_factory):
    """(JAX's results, the port's ranks' results): JAX's subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("spmd_serve")
    arrays = {}
    for arch, run in runs.items():
        ranks.flat_arrays(run["params"], f"{arch}/weights/", arrays)
        arrays[f"{arch}/prompt"] = run["prompt"]
        arrays[f"{arch}/tokens"] = run["tokens"]
        if "prefix" in run:
            arrays[f"{arch}/prefix"] = run["prefix"]
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_serve_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(runs,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


def _logits(arch, logits, want_of):
    assert len(logits) == ranks.DECODE_STEPS + 1
    for i, got in enumerate(logits):
        np.testing.assert_allclose(got, want_of(i), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL, err_msg=f"{arch} {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(both, arch):
    """The prefill's last-position logits and every decode step's, on
    every rank (each gathers them whole)."""
    jax_run, port = both
    for res in port:
        _logits(arch, res["serve"][arch]["logits"],
                lambda i: jax_run[f"{arch}/logits{i}"])


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shards_match_jax(both, arch, stage):
    """Every leaf of the cache the prefill returns and of the cache after
    the last decode step: on each mesh position the port's local shard
    has JAX's shard's shape and index (batch on ``data``, head_dim on
    ``model``), and its values within CACHE_ATOL."""
    jax_run, port = both
    prefix = f"{arch}/{stage}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    assert keys == {"pos", "blocks/k", "blocks/v"}
    for rank, res in enumerate(port):
        shards = res["serve"][arch][stage]
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                ranks.index_rows(got["offset"], got["shape"]), idx), key
            np.testing.assert_allclose(got["values"], want, rtol=CACHE_RTOL,
                                       atol=CACHE_ATOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placed_by_cache_shardings(both, arch):
    """The prefill returns its cache on ``meta["cache_sh"]`` and the decode
    step keeps it there: the KV caches on ``[Shard(1), Shard(4)]`` of
    ``(layers, B, S, H_kv, hd)``, ``pos`` replicated."""
    _, port = both
    for res in port:
        got = res["serve"][arch]
        assert got["placements"] == got["placements_want"]
        assert got["decode_placements"] == got["placements_want"]
        assert got["placements_want"]["blocks/k"] == ["S(1)", "S(4)"]
        assert got["placements_want"]["pos"] == ["R", "R"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_equals_unsharded(both, arch):
    _, port = both
    got = port[0]["serve"][arch]
    _logits(arch, got["logits"], lambda i: got["unsharded_logits"][i])


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shards_are_slices_of_the_unsharded_cache(both, arch, stage):
    """Each rank's shard of each cache leaf against its slice of the
    port's own unsharded cache, ``pos`` exactly."""
    _, port = both
    whole = port[0]["serve"][arch]["unsharded_" + stage]
    for res in port:
        shards = res["serve"][arch][stage]
        assert int(shards["pos"]["values"]) == int(whole["pos"])
        for key in ("k", "v"):
            got = shards[f"blocks/{key}"]
            sl = tuple(slice(o, o + n) for o, n in zip(got["offset"],
                                                        got["shape"]))
            np.testing.assert_allclose(got["values"],
                                       whole["blocks"][key][sl],
                                       rtol=CACHE_RTOL, atol=CACHE_ATOL)

