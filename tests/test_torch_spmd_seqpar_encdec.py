"""The ``seqpar`` set (the residual stream's sequence sharded on
``model``) on the encoder-decoder's train step sharded over a process
mesh (DTensor on 4 gloo ranks), against the JAX package's ``build_jitted``
on 4 devices, on the CPU.

The case is ``torch_spmd_ranks.SEQPAR_ENCDEC_CASES``: seamless-smoke at
2 + 2 layers with its vocabulary padded (``torch_spmd_ranks.ENCDEC_PAD``),
2 Adafactor steps at batch 4 × 16 target tokens over 4 × 16 frames.  Its
encoder's output, the memory the decoder's cross-attention reads, leaves
the last encoder block sequence-sharded; the cross-attention's K/V
projections take it so.  The weights are the port's ``init`` at seed 0
and the batches come from ``numpy.random.default_rng(1)``.  JAX runs in a
subprocess with 4 forced host devices on a ``(2, 2)`` ``("data",
"model")`` mesh with Auto axes, beside one spawn of the port's 4 ranks on
the host-staged group (``torch_spmd_ranks.run_case_ranks``).

Tolerances, each over the gap measured here (the largest on any rank,
step or leaf): losses and ``grad_norm`` at rtol 1e-5 a step (measured:
6.0e-8 and 1.2e-7); every shard of the parameters and of the Adafactor
state after each step by mesh position, its shape and index exact, its
values at atol 1e-6 (measured: 1.8e-7, in the norm scales); the port's
own unsharded step's losses at rel 1e-6 (measured: 7.7e-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks as ranks  # noqa: E402

CASES = ranks.SEQPAR_ENCDEC_CASES
CASE = "encdec-seqpar"
BATCH = 4
STEP_RTOL = 1e-5
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
TIMEOUT = 240


@pytest.fixture(scope="module")
def runs():
    return ranks.case_runs(CASES, BATCH)


@pytest.fixture(scope="module")
def both(runs, tmp_path_factory):
    return ranks.cases_both(CASES, runs,
                            tmp_path_factory.mktemp("spmd_seqpar_encdec"),
                            TIMEOUT)


def test_the_case_is_the_padded_encoder_decoder(runs):
    cfg = ranks.case_cfg(CASES[CASE])
    assert cfg == ranks.encdec_cfg() and cfg.vocab_padded > cfg.vocab
    assert CASES[CASE]["set"] == "seqpar"
    assert set(runs[CASE]["batches"][0]) == {"src_embeds", "tokens",
                                             "labels"}


@pytest.mark.parametrize("step", range(2))
def test_losses_and_grad_norm_match_jax(both, step):
    jax_run, port = both
    for res in port:
        got = res["train"][CASE]
        np.testing.assert_allclose(got["losses"][step],
                                   jax_run[f"{CASE}/loss{step}"],
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(got["grad_norms"][step],
                                   jax_run[f"{CASE}/grad_norm{step}"],
                                   rtol=STEP_RTOL)


@pytest.mark.parametrize("step", range(2))
def test_every_shard_matches_jax(both, step):
    """Every leaf of the parameters and the Adafactor state after each
    step, shard for shard by mesh position (shape, index and values)."""
    jax_run, port = both
    ranks.case_shards_match(jax_run, port, CASE, step, SHARD_ATOL)


def test_sharded_step_equals_unsharded_step(both):
    _, port = both
    got = port[0]["train"][CASE]
    np.testing.assert_allclose(got["losses"], got["unsharded_losses"],
                               rtol=UNSHARDED_RTOL)
    for res in port[1:]:
        assert res["train"][CASE]["losses"] == got["losses"]


def test_residual_is_sequence_sharded(both):
    """Every output of ``constrain(h, ("batch", "act_seq", None))`` in both
    steps, on every rank (after each encoder and decoder block), is placed
    (Shard(0), Shard(1))."""
    _, port = both
    for res in port:
        assert res["train"][CASE]["residual"] == [[("S(0)", "S(1)")]] * 2
