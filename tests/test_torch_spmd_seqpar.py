"""The override sets that shard ``act_seq`` (Megatron sequence
parallelism), on the dense and MoE families' train steps sharded over a
process mesh (DTensor on 4 gloo ranks), against the JAX package's
``build_jitted`` on 4 devices, on the CPU.

The cases are ``torch_spmd_ranks.SEQPAR_CASES``, 2 Adafactor steps each
at batch 4 × 16: ``seqpar`` on llama3-smoke (RoPE, GQA) and on
gpt2-smoke (learned positions, LayerNorms with biases); ``ep_seqpar`` and
``moe_w_seqpar`` on mixtral-smoke with the capacity dispatch (the
expert-parallel buffers, and the expert weights' contraction dims
replicated, each beside a sequence-sharded residual); the ``moe_ragged``
set's config (``moe_impl="ragged"``) under ``seqpar``'s rules on
mixtral-smoke; and ``seqpar_dots`` on llama3-smoke with ``remat=True``
(each block checkpointed, the plain matmuls' outputs saved by
``causal_lm._save_dots``).  The weights are the port's ``init`` at seed 0
and the batches come from ``numpy.random.default_rng(1)``.  JAX runs in a
subprocess with 4 forced host devices on a ``(2, 2)`` ``("data",
"model")`` mesh with Auto axes, beside one spawn of the port's 4 ranks
on the host-staged group (``torch_spmd_ranks.run_case_ranks``).

Under every set the residual stream between blocks (the output of
``constrain(h, ("batch", "act_seq", None))``) is placed ``(Shard(0),
Shard(1))``: batch on ``data``, sequence on ``model``.  DTensor
redistributes it into the attention's and the MoE dispatch's own
layouts, and back.

Tolerances, each over the gap measured here (the largest on any rank,
step or leaf): losses and ``grad_norm`` at rtol 1e-5 a step (measured:
1.2e-7 and 1.2e-7); every shard of the parameters and of the Adafactor
state after each step by mesh position, its shape and index exact, its
values at atol 1e-6 (measured: 1.2e-7, in the norm scales); the port's
own unsharded step's losses at rel 1e-6 (measured: 7.6e-8).  Both
capacity cases drop 9 (token, choice) entries in step 2's first layer,
as JAX's do (the shards show it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks as ranks  # noqa: E402

CASES = ranks.SEQPAR_CASES
BATCH = 4
STEP_RTOL = 1e-5
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
TIMEOUT = 240
SEQUENCE_SHARDED = [("S(0)", "S(1)")]


@pytest.fixture(scope="module")
def runs():
    return ranks.case_runs(CASES, BATCH)


@pytest.fixture(scope="module")
def both(runs, tmp_path_factory):
    return ranks.cases_both(CASES, runs,
                            tmp_path_factory.mktemp("spmd_seqpar"), TIMEOUT)


def test_every_case_shards_the_sequence():
    """Each case's set names ``act_seq``, and the seqpar_dots case
    checkpoints its blocks with the dots policy."""
    from repro_torch.perf import overrides
    for name, case in CASES.items():
        assert overrides.get(case["set"])["rules"]["act_seq"] == "model", name
    cfg = ranks.case_cfg(CASES["llama3-seqpar_dots"])
    assert cfg.remat and cfg.remat_policy == "dots"
    assert ranks.case_cfg(CASES["mixtral-ragged-seqpar"]).moe_impl == "ragged"


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
    step, shard for shard by mesh position (shape, index and values);
    ``moe_w_seqpar`` places the expert weights by its overrides."""
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


@pytest.mark.parametrize("case", list(CASES))
def test_residual_is_sequence_sharded(both, case):
    """Every output of ``constrain(h, ("batch", "act_seq", None))`` in every
    step, on every rank, is placed (Shard(0), Shard(1))."""
    _, port = both
    for res in port:
        assert res["train"][case]["residual"] == \
            [SEQUENCE_SHARDED] * CASES[case]["steps"]


def test_ragged_dispatch_drops_nothing_under_seqpar(both):
    """The ragged dispatch beside a sequence-sharded residual drops no
    (token, choice) entry and multiplies each once on every rank (no set
    here splits the experts)."""
    _, port = both
    case = "mixtral-ragged-seqpar"
    cfg = ranks.case_cfg(CASES[case])
    for res in port:
        got = res["train"][case]
        assert got["dropped"] == [[0] * cfg.n_layers] * CASES[case]["steps"]
        assert got["grouped_rows"] == [3 * cfg.n_layers * BATCH * ranks.SEQ
                                       * cfg.top_k] * CASES[case]["steps"]
