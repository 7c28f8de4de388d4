"""The ragged MoE dispatch in the prefill and decode steps sharded over a
process mesh (DTensor on 4 gloo ranks) against the JAX package's
``build_jitted`` on 4 devices, on the CPU.

mixtral-smoke with ``moe_impl="ragged"`` (its smoke config's own), the
port's ``init`` at seed 0, a prompt of 4 × 16 tokens from
``numpy.random.default_rng(2)``.  JAX runs ``build_jitted``'s jitted
prefill (a 32-slot cache out on ``cache_shardings``) and 4 greedy steps of
its decode step (the cache in and out on them) in a subprocess with 4
forced host devices on a ``(2, 2)`` ``("data", "model")`` mesh with Auto
axes, beside one spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_ragged_serve_ranks``), whose MoE layers run
``moe._ragged_sharded``: a decode step routes 4 tokens, so most experts'
groups are small or empty.  Each side picks its own greedy tokens.

Tolerances, each over the gap measured here (the largest on any rank or
step): the logits of the prefill and of every decode step at rtol 1e-5,
atol 1e-6 (measured: 8.5e-7 absolute; 8.9e-7 from the port's unsharded
steps), and the greedy tokens equal; every shard of the KV cache after
the prefill and after the last step by mesh position, its shape and index
exact, its values at rtol 1e-5, atol 1e-5, as ``test_torch_spmd_serve``
holds them (measured: 2.6e-6); the port's own unsharded steps at the
same tolerances.
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
BATCH = 4
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
CACHE_RTOL, CACHE_ATOL = 1e-5, 1e-5
TIMEOUT = 240

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import resolve
    from repro.configs.base import InputShape
    from repro.distributed.sharding import use_mesh
    from repro.distributed.steps import build_jitted

    ARCH, L, STEPS = {arch!r}, {cache_len}, {steps}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    cfg = resolve(ARCH).smoke.replace(moe_impl="ragged")
    prompt = z["prompt"]
    B = prompt.shape[0]
    pf, _, _ = build_jitted(cfg, mesh, InputShape("p", L, B, "prefill"))
    df, _, _ = build_jitted(cfg, mesh, InputShape("d", L, B, "decode"))
    params = tree("weights/")
    with use_mesh(mesh):
        logits, cache = pf(params, {{"tokens": prompt}})
    out["logits0"] = np.asarray(logits)
    shards("prefill_cache/", cache)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        out[f"tokens{{i}}"] = tok.astype(np.int32)
        with use_mesh(mesh):
            logits, cache = df(params, cache, tok.astype(np.int32))
        out[f"logits{{i + 1}}"] = np.asarray(logits)
    shards("cache/", cache)
    np.savez(sys.argv[2], **out)
""").format(helpers=ranks.JAX_HELPERS, arch=ranks.RAGGED_SERVE_ARCH,
         cache_len=ranks.CACHE_LEN, steps=ranks.DECODE_STEPS)


@pytest.fixture(scope="module")
def run():
    cfg = ranks.smoke_cfg(ranks.RAGGED_SERVE_ARCH, "ragged")
    rng = np.random.default_rng(2)
    return {"params": to_numpy_tree(causal_lm.init(
                cfg, torch.Generator().manual_seed(0))),
            "prompt": rng.integers(0, cfg.vocab, (BATCH, ranks.PROMPT))
            .astype(np.int32),
            "greedy": ranks.DECODE_STEPS}


@pytest.fixture(scope="module")
def both(run, tmp_path_factory):
    """(JAX's results, the port's ranks' results): JAX's subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("spmd_moe_ragged_serve")
    arrays = {"prompt": run["prompt"]}
    ranks.flat_arrays(run["params"], "weights/", arrays)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_ragged_serve_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(run,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), [r["serve"] for r in port]


def _logits(logits, want_of):
    assert len(logits) == ranks.DECODE_STEPS + 1
    for i, got in enumerate(logits):
        np.testing.assert_allclose(got, want_of(i), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")


def test_the_config_is_ragged():
    cfg = ranks.smoke_cfg(ranks.RAGGED_SERVE_ARCH, "ragged")
    assert cfg.family == "moe" and cfg.moe_impl == "ragged"


def test_logits_match_jax(both):
    """The prefill's last-position logits and every decode step's, on
    every rank (each gathers them whole)."""
    jax_run, port = both
    for res in port:
        _logits(res["logits"], lambda i: jax_run[f"logits{i}"])


def test_greedy_tokens_match_jax(both):
    jax_run, port = both
    want = [jax_run[f"tokens{i}"][:, 0].tolist()
            for i in range(ranks.DECODE_STEPS)]
    for res in port:
        assert res["tokens"] == want


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
def test_cache_shards_match_jax(both, stage):
    """Every leaf of the cache the prefill returns and of the cache after
    the last decode step: on each mesh position the port's local shard
    has JAX's shard's shape and index, and its values within CACHE_ATOL
    and CACHE_RTOL."""
    jax_run, port = both
    prefix = f"{stage}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    assert keys == {"pos", "blocks/k", "blocks/v"}
    for rank, res in enumerate(port):
        shards = res[stage]
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                ranks.index_rows(got["offset"], got["shape"]), idx), key
            np.testing.assert_allclose(got["values"], want, rtol=CACHE_RTOL,
                                       atol=CACHE_ATOL, err_msg=key)


def test_cache_placed_by_cache_shardings(both):
    """The prefill returns its cache on ``meta["cache_sh"]`` and the decode
    step keeps it there: the KV caches with batch on ``data`` and head_dim
    on ``model``."""
    _, port = both
    for res in port:
        assert res["placements"] == res["placements_want"]
        assert res["decode_placements"] == res["placements_want"]
        assert res["placements_want"]["blocks/k"] == ["S(1)", "S(4)"]


def test_sharded_serving_equals_unsharded(both):
    _, port = both
    got = port[0]
    _logits(got["logits"], lambda i: got["unsharded_logits"][i])
    assert got["tokens"] == got["unsharded_tokens"]


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
def test_cache_shards_are_slices_of_the_unsharded_cache(both, stage):
    """Each rank's shard of each cache leaf against its slice of the
    port's own unsharded cache, ``pos`` exactly."""
    _, port = both
    whole = port[0]["unsharded_" + stage]
    for res in port:
        shards = res[stage]
        assert int(shards["pos"]["values"]) == int(whole["pos"])
        for key, got in shards.items():
            if key == "pos":
                continue
            seg, leaf = key.split("/")
            sl = tuple(slice(o, o + n) for o, n in zip(got["offset"],
                                                        got["shape"]))
            np.testing.assert_allclose(got["values"], whole[seg][leaf][sl],
                                       rtol=CACHE_RTOL, atol=CACHE_ATOL,
                                       err_msg=key)
