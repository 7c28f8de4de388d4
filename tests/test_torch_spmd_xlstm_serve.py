"""The xLSTM family's prefill and decode steps sharded over a process mesh
(DTensor on 4 gloo ranks) against the JAX package's ``build_jitted`` on 4
devices, on the CPU.

xlstm-smoke cut to 5 layers (2 groups of one mLSTM and one sLSTM block,
then a 1-layer mLSTM tail), the port's ``init`` at seed 0, a prompt of 4
× 16 tokens from ``numpy.random.default_rng(2)``.  JAX runs
``build_jitted``'s jitted prefill (a 32-slot cache out on
``cache_shardings``) and 4 greedy steps of its decode step (the cache in
and out on them) in a subprocess with 4 forced host devices on a ``(2,
2)`` ``("data", "model")`` mesh with Auto axes, beside one spawn of the
port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_xlstm_serve_ranks``).  Each side picks its own
greedy tokens.  The cache holds the mLSTM states (the matrix memory ``C``
and ``n`` with the key axis on ``model``, the stabilizer ``m`` with the
heads on it, the conv window with the channels), the sLSTM states (the
head dim on ``model``) and ``pos``; the groups' and the tail's.  The
decode step keeps ``C`` where the cache holds it: no tensor of its
trailing shape crosses the staged group, and the bytes staged inside the
matrix-memory update stay below the ``C`` a rank holds.  At this size
the whole step stages more than that: ``C`` is small beside the step's
other traffic.

Tolerances, each over a measured gap (the largest on any rank, step or
leaf): the logits of the prefill and of every decode step against JAX's
at rtol 1e-5, atol 1e-5 (measured: 2.6e-6 at most, max |logit| 0.70),
and the greedy tokens equal; every shard of the cache after the prefill
and after the last step by mesh position, its shape and index exact, its
values at rtol 1e-5 and atol 1e-5 times the leaf's largest |value|
(measured: 3.9e-6 of it); the port's own unsharded steps, the logits and
each cache leaf, within rel 1e-5 of their largest |value| (measured:
4.0e-6 and 3.9e-6).  The states are running sums, and fp32 puts them
that far apart: a float64 run put both packages' unsharded ``C`` 1.3e-5
to 1.7e-5 from it (``test_torch_xlstm_lm``).
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
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-5
CACHE_RTOL, CACHE_ATOL = 1e-5, 1e-5
UNSHARDED_REL = 1e-5        # against the port's unsharded steps
TIMEOUT = 240
# the cache's placements, by leaf, as JAX's jitted prefill and decode
# steps place it (their out_shardings): a Shard dim or R a mesh axis
PLACEMENTS = {"pos": ["R", "R"],
              "groups/m/C": ["S(2)", "S(5)"], "groups/m/n": ["S(2)", "S(4)"],
              "groups/m/m": ["R", "S(3)"], "groups/m/conv": ["S(2)", "S(4)"],
              "groups/s/c": ["S(1)", "S(3)"], "groups/s/n": ["S(1)", "S(3)"],
              "groups/s/h": ["S(1)", "S(3)"], "groups/s/m": ["S(1)", "S(3)"],
              "tail/C": ["S(1)", "S(4)"], "tail/n": ["S(1)", "S(3)"],
              "tail/m": ["R", "S(2)"], "tail/conv": ["S(1)", "S(3)"]}

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

    ARCH, LAYERS, L, STEPS = {arch!r}, {layers}, {cache_len}, {steps}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    cfg = resolve(ARCH).smoke.replace(n_layers=LAYERS)
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
""").format(helpers=ranks.JAX_HELPERS, arch=ranks.XLSTM_ARCH,
         layers=ranks.XLSTM_LAYERS, cache_len=ranks.CACHE_LEN,
         steps=ranks.DECODE_STEPS)


@pytest.fixture(scope="module")
def run():
    cfg = ranks.xlstm_cfg()
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
    tmp = tmp_path_factory.mktemp("spmd_xlstm_serve")
    arrays = {"prompt": run["prompt"]}
    ranks.flat_arrays(run["params"], "weights/", arrays)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_xlstm_serve_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(run,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), [r["serve"] for r in port], port


def _cache_atol(*parts) -> float:
    """CACHE_ATOL times the largest |value| of a cache leaf (given whole or
    as its shards): the recurrent states are running sums."""
    return CACHE_ATOL * max(float(np.abs(p).max()) for p in parts
                            if np.size(p))


def _rel(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _logits(logits, want_of):
    assert len(logits) == ranks.DECODE_STEPS + 1
    for i, got in enumerate(logits):
        np.testing.assert_allclose(got, want_of(i), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")


def test_logits_match_jax(both):
    """The prefill's last-position logits and every decode step's, on
    every rank (each gathers them whole)."""
    jax_run, port, _ = both
    for res in port:
        _logits(res["logits"], lambda i: jax_run[f"logits{i}"])


def test_greedy_tokens_match_jax(both):
    jax_run, port, _ = both
    want = [jax_run[f"tokens{i}"][:, 0].tolist()
            for i in range(ranks.DECODE_STEPS)]
    for res in port:
        assert res["tokens"] == want


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
def test_cache_shards_match_jax(both, stage):
    """Every leaf of the cache the prefill returns and of the cache after
    the last decode step: on each mesh position the port's local shard
    has JAX's shard's shape and index, and its values within CACHE_RTOL
    and :func:`_cache_atol`."""
    jax_run, port, _ = both
    prefix = f"{stage}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    assert keys == set(PLACEMENTS)
    for rank, res in enumerate(port):
        shards = res[stage]
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                ranks.index_rows(got["offset"], got["shape"]), idx), key
            leaf = [jax_run[f"{prefix}{key}@{r}"] for r in range(len(port))]
            np.testing.assert_allclose(got["values"], want, rtol=CACHE_RTOL,
                                       atol=_cache_atol(*leaf), err_msg=key)


def test_cache_placed_as_jax_places_it(both):
    """The prefill returns its cache on ``meta["cache_sh"]`` and the decode
    step keeps it there, placed as JAX's jitted steps place it: ``C`` and
    ``n`` with batch on ``data`` and the key axis on ``model``, ``m`` with
    the heads on ``model`` and its batch whole (``cache_shardings`` looks
    for the batch one axis further out), the sLSTM states with the head
    dim on ``model``."""
    _, port, _ = both
    for res in port:
        assert res["placements_want"] == PLACEMENTS
        assert res["placements"] == PLACEMENTS
        assert res["decode_placements"] == PLACEMENTS


def test_sharded_serving_equals_unsharded(both):
    _, port, _ = both
    got = port[0]
    assert len(got["logits"]) == ranks.DECODE_STEPS + 1
    for i, logits in enumerate(got["logits"]):
        assert _rel(logits, got["unsharded_logits"][i]) <= UNSHARDED_REL, i
    assert got["tokens"] == got["unsharded_tokens"]


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
def test_cache_shards_are_slices_of_the_unsharded_cache(both, stage):
    """Each rank's shard of each cache leaf against its slice of the
    port's own unsharded cache, ``pos`` exactly."""
    _, port, _ = both
    whole = port[0]["unsharded_" + stage]
    for res in port:
        shards = res[stage]
        assert int(shards["pos"]["values"]) == int(whole["pos"])
        for key, got in shards.items():
            if key == "pos":
                continue
            want = whole
            for part in key.split("/"):
                want = want[part]
            sl = tuple(slice(o, o + n) for o, n in zip(got["offset"],
                                                        got["shape"]))
            gap = float(np.abs(got["values"] - want[sl]).max())
            assert gap <= UNSHARDED_REL * float(np.abs(want).max()), key


def test_decode_step_leaves_the_matrix_memory_in_place(both):
    """In every sharded decode step, on every rank: no tensor the staged
    group carries ends in a layer's ``C`` shape (head_dim × head_dim) or
    its shard's (head_dim × head_dim / 2), and the bytes staged inside the
    mLSTM blocks' matrix-memory update (the read-outs' sums over the key
    axis, the gates and q, k, v cut to each rank's rows and keys) stay
    below the bytes of ``C`` the rank holds."""
    _, serve, port = both
    hd = ranks.xlstm_cfg().d_model * 2 // ranks.xlstm_cfg().n_heads
    for res, raw in zip(serve, port):
        c_bytes = sum(np.asarray(v["values"]).nbytes
                      for k, v in res["cache"].items() if k.endswith("/C"))
        assert c_bytes > 0
        steps = raw["decode_shapes"][:ranks.DECODE_STEPS]
        assert len(steps) == ranks.DECODE_STEPS and all(steps)
        for shapes in steps:
            assert not [s for s in shapes
                        if s[-2:] in ((hd, hd), (hd, hd // 2))], shapes
        for staged in raw["matrix_staged_bytes"][:ranks.DECODE_STEPS]:
            assert 0 < staged < c_bytes, (staged, c_bytes)
