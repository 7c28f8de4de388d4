"""The encoder-decoder's prefill and decode steps sharded over a process mesh
(DTensor on 4 gloo ranks) against the JAX package's ``build_jitted`` on 4
devices, on the CPU.

seamless-smoke cut to 2 + 2 layers with its vocabulary padded
(``torch_spmd_ranks.ENCDEC_PAD``), the port's ``init`` at seed 0, 4 × 16
frame embeddings and a 4 × 16-token target prefix from
``numpy.random.default_rng(2)``.  JAX runs ``build_jitted``'s jitted
prefill (a 32-slot self-attention cache and the source's cross-attention
K/V, out on ``cache_shardings``) and 4 greedy steps of its decode step
(the cache in and out on them) in a subprocess with 4 forced host devices
on a ``(2, 2)`` ``("data", "model")`` mesh with Auto axes, beside one
spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_encdec_serve_ranks``).  Each side picks its own
greedy tokens.  Every cache leaf (``k``, ``v``, ``xk``, ``xv``) has the
batch on ``data`` and head_dim on ``model``.  The prefill projects the
cross-attention K/V onto those shards with one staged collective each,
and a decode step attends over each rank's slice of head_dim: no tensor
of the K/V's shape, whole or cut, crosses the staged group.

Tolerances, each over a measured gap (the largest on any rank, step or
leaf): the logits of the prefill and of every decode step against JAX's
at rtol 1e-5, atol 1e-5 (measured: 7.2e-7 at most, max |logit| 0.88), and
the greedy tokens equal; every shard of the cache after the prefill and
after the last step by mesh position, its shape and index exact, its
values at rtol 1e-5 and atol 1e-5 (measured: 3.1e-6); the port's own
unsharded steps, the logits over the true vocabulary and each cache leaf,
within rel 1e-5 of their largest |value| (measured: 8.2e-7 and 7.8e-7).
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
BATCH = 4
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-5
CACHE_RTOL, CACHE_ATOL = 1e-5, 1e-5
UNSHARDED_REL = 1e-5        # against the port's unsharded steps
TIMEOUT = 240
# the cache's placements, by leaf, as JAX's jitted prefill and decode
# steps place it (their out_shardings): a Shard dim or R a mesh axis
KV = ["S(1)", "S(4)"]
PLACEMENTS = {"pos": ["R", "R"], "dec/k": KV, "dec/v": KV, "dec/xk": KV,
              "dec/xv": KV}

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

    ARCH, PAD, L, STEPS = {arch!r}, {pad!r}, {cache_len}, {steps}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    cfg = resolve(ARCH).smoke.replace(**PAD)
    B = z["prompt"].shape[0]
    pf, _, _ = build_jitted(cfg, mesh, InputShape("p", L, B, "prefill"))
    df, _, _ = build_jitted(cfg, mesh, InputShape("d", L, B, "decode"))
    params = tree("weights/")
    with use_mesh(mesh):
        logits, cache = pf(params, {{"src_embeds": z["src"],
                                     "tokens": z["prompt"]}})
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
""").format(helpers=ranks.JAX_HELPERS, arch=ranks.ENCDEC_ARCH,
         pad=ranks.ENCDEC_PAD, cache_len=ranks.CACHE_LEN,
         steps=ranks.DECODE_STEPS)


@pytest.fixture(scope="module")
def run():
    cfg = ranks.encdec_cfg()
    rng = np.random.default_rng(2)
    src_len = src_len_for(cfg, ranks.CACHE_LEN)
    return {"params": to_numpy_tree(encdec.init(
                cfg, torch.Generator().manual_seed(0))),
            "src": rng.standard_normal((BATCH, src_len, cfg.d_frontend))
            .astype(np.float32),
            "prompt": rng.integers(0, cfg.vocab, (BATCH, ranks.PROMPT))
            .astype(np.int32),
            "greedy": ranks.DECODE_STEPS}


@pytest.fixture(scope="module")
def both(run, tmp_path_factory):
    """(JAX's results, the port's serving results, the ranks' whole
    results): JAX's subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("spmd_encdec_serve")
    arrays = {"prompt": run["prompt"], "src": run["src"]}
    ranks.flat_arrays(run["params"], "weights/", arrays)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_encdec_serve_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(run,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), [r["serve"] for r in port], port


def _rel(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_logits_match_jax(both):
    """The prefill's last-position logits and every decode step's, on
    every rank (each gathers them whole), the padded classes at -1e30 as
    in JAX."""
    jax_run, port, _ = both
    cfg = ranks.encdec_cfg()
    for res in port:
        assert len(res["logits"]) == ranks.DECODE_STEPS + 1
        for i, got in enumerate(res["logits"]):
            np.testing.assert_allclose(got, jax_run[f"logits{i}"],
                                       rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
                                       err_msg=f"step {i}")
            assert (got[..., cfg.vocab:] == -1e30).all()


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
    and CACHE_ATOL."""
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
            np.testing.assert_allclose(got["values"], want, rtol=CACHE_RTOL,
                                       atol=CACHE_ATOL, err_msg=key)


def test_cache_placed_as_jax_places_it(both):
    """The prefill returns its cache on ``meta["cache_sh"]`` and the decode
    step keeps it there, placed as JAX's jitted steps place it: the self-
    and cross-attention K/V with the batch on ``data`` and head_dim on
    ``model``, ``pos`` replicated."""
    _, port, _ = both
    for res in port:
        assert res["placements_want"] == PLACEMENTS
        assert res["placements"] == PLACEMENTS
        assert res["decode_placements"] == PLACEMENTS


def test_sharded_serving_equals_unsharded(both):
    _, port, _ = both
    got = port[0]
    assert len(got["logits"]) == ranks.DECODE_STEPS + 1
    cfg = ranks.encdec_cfg()
    for i, logits in enumerate(got["logits"]):
        assert _rel(logits[..., :cfg.vocab],
                    got["unsharded_logits"][i][..., :cfg.vocab]) \
            <= UNSHARDED_REL, i
    assert got["tokens"] == got["unsharded_tokens"]


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
def test_cache_shards_are_slices_of_the_unsharded_cache(both, stage):
    """Each rank's shard of each cache leaf against its slice of the
    port's own unsharded cache, ``pos`` exactly; the cross-attention K/V
    after the last step are the prefill's, unchanged."""
    _, port, _ = both
    whole = port[0]["unsharded_" + stage]
    for res in port:
        shards = res[stage]
        assert int(shards["pos"]["values"]) == int(whole["pos"])
        for key, got in shards.items():
            if key == "pos":
                continue
            want = whole["dec"][key.split("/")[1]]
            sl = tuple(slice(o, o + n) for o, n in zip(got["offset"],
                                                        got["shape"]))
            gap = float(np.abs(got["values"] - want[sl]).max())
            assert gap <= UNSHARDED_REL * float(np.abs(want).max()), key
        for key in ("dec/xk", "dec/xv"):
            assert np.array_equal(shards[key]["values"],
                                  res["prefill_cache"][key]["values"])


def test_prefill_projects_the_cross_kv_onto_its_shards(both):
    """Each decoder layer's ``_cross_kv`` in the sharded prefill stages one
    collective for each of K and V besides their projections: the heads,
    which the projections leave on ``model``, move to head_dim there
    once (gloo's all-to-all on the CPU is one all-gather).  Rank 0's
    unsharded prefill stages none."""
    _, _, port = both
    n_dec = ranks.encdec_cfg().n_dec_layers
    for raw in port:
        got = raw["cross_kv_staged_calls"]
        assert got[:n_dec] == [2] * n_dec, got
        assert not any(got[n_dec:]), got


def test_decode_step_leaves_the_cross_kv_on_its_shards(both):
    """In every sharded decode step, on every rank: no tensor the staged
    group carries has the cross-attention K/V's trailing shape, a layer's
    shard (S_src, H_kv, hd / 2) or its whole head_dim (S_src, H_kv, hd),
    nor their flat projection (S_src, H_kv · hd); and each layer's
    cross-attention stages, besides its two projections, fewer bytes (q's
    gather, the partial scores' sums, the output's gather) than that
    layer's K/V shards on the rank."""
    _, serve, port = both
    cfg = ranks.encdec_cfg()
    n_dec = cfg.n_dec_layers
    s_src, h, hd = (src_len_for(cfg, ranks.CACHE_LEN), cfg.n_kv_heads,
                    cfg.head_dim)
    banned = {(s_src, h, hd // 2), (s_src, h, hd)}
    for res, raw in zip(serve, port):
        kv_bytes = sum(np.asarray(res["cache"][k]["values"]).nbytes
                       for k in ("dec/xk", "dec/xv")) // n_dec
        steps = raw["decode_shapes"][:ranks.DECODE_STEPS]
        assert len(steps) == ranks.DECODE_STEPS and all(steps)
        for shapes in steps:
            assert not [s for s in shapes if s[-3:] in banned
                        or s[-2:] == (s_src, h * hd)], shapes
        layers = raw["cross_attn_staged_bytes"][
            n_dec:n_dec * (ranks.DECODE_STEPS + 1)]
        assert len(layers) == n_dec * ranks.DECODE_STEPS
        assert all(0 < b < kv_bytes for b in layers), (layers, kv_bytes)
