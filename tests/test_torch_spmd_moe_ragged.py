"""The ragged and loop MoE dispatches in the train step sharded over a
process mesh (DTensor on 4 gloo ranks) against the JAX package's
``build_jitted`` on 4 devices, on the CPU.

The cases are ``torch_spmd_ranks.RAGGED_CASES``: 2 Adafactor steps of
``build_jitted``'s train step at batch 4 × 16 for mixtral-smoke with
``moe_impl="ragged"`` under the default rules and under the ``ep`` set,
for deepseek-moe-smoke (a shared expert) with ``"ragged"``, and for
mixtral-smoke with ``"loop"`` (the oracle, plain DTensor ops).  The
weights are the port's ``init`` at seed 0 and the batches come from
``numpy.random.default_rng(1)``, both made here and handed to the two
sides as numpy arrays.  JAX runs in a subprocess with 4 forced host
devices on a ``(2, 2)`` ``("data", "model")`` mesh with Auto axes, beside
one spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_case_ranks``).  The JAX package's ``moe_ragged``
makes no ``constrain`` call, so the ``ep`` rule leaves its function as it
is; the port's sharded ragged dispatch (``moe._ragged_sharded``) then
splits the experts over ``model``, and its result must be the same.

Tolerances, each over the gap measured here (the largest on any rank,
step or leaf): losses and ``grad_norm`` at rtol 1e-5 a step (measured:
1.2e-7 and 1.2e-7); every shard of the parameters and of the Adafactor
state after each step by mesh position, its shape and index exact, its
values at atol 1e-6 (measured: 1.2e-7, in the norm scales); the port's own
unsharded step's losses at rel 1e-6 (measured: 7.6e-8).  Drops are exact:
none, and every (token, choice) entry goes through exactly one shard of
the experts' grouped matmuls.  A step stages 16.67 MB a rank under the
default rules and 18.94 MB under ``ep`` (the capacity dispatch's default:
16.88 MB).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks as ranks  # noqa: E402

CASES = ranks.RAGGED_CASES
BATCH = 4
STEP_RTOL = 1e-5
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
TIMEOUT = 240
# the shards of the experts the ragged dispatch splits them into: the
# ep set's rule puts them on model's 2 ranks; otherwise every rank holds
# every expert
EXPERT_SHARDS = {"mixtral-ragged-ep": 2}


@pytest.fixture(scope="module")
def runs():
    return ranks.case_runs(CASES, BATCH)


@pytest.fixture(scope="module")
def both(runs, tmp_path_factory):
    return ranks.cases_both(CASES, runs,
                            tmp_path_factory.mktemp("spmd_moe_ragged"),
                            TIMEOUT)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grad_norm_match_jax(both, case):
    jax_run, port = both
    for res in port:
        got = res["train"][case]
        for i in range(CASES[case]["steps"]):
            np.testing.assert_allclose(got["losses"][i],
                                       jax_run[f"{case}/loss{i}"],
                                       rtol=STEP_RTOL)
            np.testing.assert_allclose(got["grad_norms"][i],
                                       jax_run[f"{case}/grad_norm{i}"],
                                       rtol=STEP_RTOL)


@pytest.mark.parametrize("step", range(2))
@pytest.mark.parametrize("case", list(CASES))
def test_every_shard_matches_jax(both, case, step):
    """Every leaf of the parameters and the Adafactor state after each
    step, shard for shard by mesh position (shape, index and values)."""
    jax_run, port = both
    ranks.case_shards_match(jax_run, port, case, step, SHARD_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded_step(both, case):
    _, port = both
    got = port[0]["train"][case]
    np.testing.assert_allclose(got["losses"], got["unsharded_losses"],
                               rtol=UNSHARDED_RTOL)
    for res in port[1:]:
        assert res["train"][case]["losses"] == got["losses"]


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c]["impl"] == "ragged"])
def test_ragged_dispatch_drops_nothing(both, case):
    """The ragged dispatch plans no drop in either MoE layer of a step, and
    its grouped matmuls take every (token, choice) entry exactly once a
    shard of the experts: over the 4 ranks, 3 projections × 2 layers ×
    T·K rows a step, times the ranks that hold each shard."""
    _, port = both
    cfg = ranks.case_cfg(CASES[case])
    T = BATCH * ranks.SEQ
    holders = 4 // EXPERT_SHARDS.get(case, 1)
    for step in range(CASES[case]["steps"]):
        rows = 0
        for res in port:
            got = res["train"][case]
            assert got["dropped"][step] == [0] * cfg.n_layers, got["dropped"]
            rows += got["grouped_rows"][step]
        assert rows == 3 * cfg.n_layers * T * cfg.top_k * holders, rows


def test_loop_dispatch_has_no_plan(both):
    """The loop dispatch (every expert on every token, masked) plans no
    buffer: neither the capacity plan nor a grouped matmul runs."""
    _, port = both
    for res in port:
        got = res["train"]["mixtral-loop"]
        assert got["dropped"] == [[], []] and got["grouped_rows"] == [0, 0]
