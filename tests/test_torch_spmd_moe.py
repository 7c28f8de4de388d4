"""The MoE family's train step sharded over a process mesh (DTensor on 4
gloo ranks) against the JAX package's ``build_jitted`` on 4 devices, on
the CPU.

The weights are the port's ``init`` at seed 0 and the batches come from
``numpy.random.default_rng(1)``, both made here and handed to the two
sides as numpy arrays.  JAX runs in a subprocess with 4 forced host
devices on a ``(2, 2)`` ``("data", "model")`` mesh with Auto axes, beside
one spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_moe_ranks``): 2 Adafactor steps of
``build_jitted``'s train step at batch 4 × 16 for mixtral-smoke under the
default rules, the ``ep`` set (the (E, C, d) dispatch buffers sharded over
``model``) and the ``moe_w`` set (the expert weights' contraction
dimensions replicated), and for deepseek-moe-smoke (a shared expert) under
the default rules, every one with ``moe_impl="capacity"``.  Each case
drops (token, choice) entries at capacity, so a dispatch that counted
positions over each rank's own rows would drop others and fail.

Tolerances: losses and ``grad_norm`` at rtol 1e-4 a step, as
``test_torch_spmd`` holds the dense family; every shard's values at atol
1e-6 by mesh position; the sharded loss against the port's own unsharded
step at rel 1e-6.  The shards' shapes and indices are exact.
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
ARCHS = sorted({arch for arch, _ in ranks.MOE_CASES.values()})
BATCH = 4
STEP_RTOL = 1e-4
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
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
    from repro.perf import overrides

    CASES, STEPS = {cases!r}, {steps}
    z = np.load(sys.argv[1])
    out = {{}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}

    {helpers}
    for case, (arch, set_name) in CASES.items():
        cfg = resolve(arch).smoke.replace(moe_impl="capacity")
        ov = overrides.get(set_name) or {{}}
        B, S = z[f"{{arch}}/batch0/tokens"].shape
        fn, _, _ = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"),
                                param_overrides=ov.get("param_overrides"))
        params = tree(f"{{arch}}/weights/")
        state = adafactor(1e-3).init(params)
        for i in range(STEPS):
            batch = {{k: z[f"{{arch}}/batch{{i}}/{{k}}"]
                     for k in ("tokens", "labels")}}
            with use_mesh(mesh, ov.get("rules")):
                params, state, m = fn(params, state, batch)
            out[f"{{case}}/loss{{i}}"] = np.asarray(m["loss"])
            out[f"{{case}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        shards(f"{{case}}/shard/param/", params)
        shards(f"{{case}}/shard/opt/", state)
    np.savez(sys.argv[2], **out)
""").format(helpers=ranks.JAX_HELPERS, cases=ranks.MOE_CASES,
         steps=ranks.MOE_STEPS)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for arch in ARCHS:
        cfg = ranks.smoke_cfg(arch)
        params = to_numpy_tree(causal_lm.init(
            cfg, torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(1)
        batches = [{k: rng.integers(0, cfg.vocab, (BATCH, ranks.SEQ))
                    .astype(np.int32) for k in ("tokens", "labels")}
                   for _ in range(ranks.MOE_STEPS)]
        out[arch] = {"params": params, "batches": batches}
    return out


@pytest.fixture(scope="module")
def both(runs, tmp_path_factory):
    """(JAX's results, the port's ranks' results): JAX's subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("spmd_moe")
    arrays = {}
    for arch, run in runs.items():
        ranks.flat_arrays(run["params"], f"{arch}/weights/", arrays)
        for i, b in enumerate(run["batches"]):
            for k, v in b.items():
                arrays[f"{arch}/batch{i}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_moe_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(runs,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


CASES = list(ranks.MOE_CASES)


@pytest.mark.parametrize("case", CASES)
def test_losses_and_grad_norm_match_jax(both, case):
    jax_run, port = both
    for res in port:
        got = res["train"][case]
        for i in range(ranks.MOE_STEPS):
            np.testing.assert_allclose(got["losses"][i],
                                       jax_run[f"{case}/loss{i}"],
                                       rtol=STEP_RTOL)
            np.testing.assert_allclose(got["grad_norms"][i],
                                       jax_run[f"{case}/grad_norm{i}"],
                                       rtol=STEP_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_every_shard_matches_jax(both, case):
    """Every leaf of the parameters and the Adafactor state after the last
    step: on each mesh position the port's local shard has JAX's shard's
    shape and index, and its values within SHARD_ATOL."""
    jax_run, port = both
    prefix = f"{case}/shard/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    for rank, res in enumerate(port):
        shards = res["train"][case]["shards"]
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(
                ranks.index_rows(got["offset"], got["shape"]), idx), key
            np.testing.assert_allclose(got["values"], want, rtol=0,
                                       atol=SHARD_ATOL, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_equals_unsharded_step(both, case):
    _, port = both
    got = port[0]["train"][case]
    np.testing.assert_allclose(got["losses"], got["unsharded_losses"],
                               rtol=UNSHARDED_RTOL)
    for res in port[1:]:
        assert res["train"][case]["losses"] == got["losses"]


@pytest.mark.parametrize("case", CASES)
def test_capacity_drops_entries(both, case):
    """Each case drops (token, choice) entries at capacity (the counts of
    each step's two layers), and every rank plans the same drops:
    positions count over the global batch."""
    _, port = both
    dropped = port[0]["train"][case]["dropped"]
    assert [len(d) for d in dropped] == [2] * ranks.MOE_STEPS
    assert sum(map(sum, dropped)) >= 1, dropped
    for res in port[1:]:
        assert res["train"][case]["dropped"] == dropped


@pytest.mark.parametrize("arch,impl", ranks.BUILT,
                         ids=[f"{a}-{i}" if i else a for a, i in ranks.BUILT])
def test_every_family_and_dispatch_builds_on_a_process_mesh(both, arch,
                                                            impl):
    """``build_jitted`` builds the train, prefill and decode steps on the
    process mesh for every family and every MoE dispatch: none raises
    (``NotImplementedError`` or other)."""
    _, port = both
    for res in port:
        for kind in ("train", "prefill", "decode"):
            assert res["built"][(arch, impl, kind)] == "built", \
                res["built"][(arch, impl, kind)]
