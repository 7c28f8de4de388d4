"""The ``seqpar`` set (the residual stream's sequence sharded on
``model``) on the hybrid and xLSTM families' train steps sharded over a
process mesh (DTensor on 4 gloo ranks), against the JAX package's
``build_jitted`` on 4 devices, on the CPU (the encoder-decoder's:
``test_torch_spmd_seqpar_encdec.py``).

The cases are ``torch_spmd_ranks.SEQPAR_FAMILY_CASES`` at batch 4 × 16:
zamba2-smoke cut to 7 layers, 2 Adafactor steps (the SSD's five
``constrain`` calls and the scan on each rank's rows and heads take the
projections of a sequence-sharded residual); xlstm-smoke cut to 5 layers,
one step (the mLSTM and sLSTM on each rank's rows and heads).  The
weights are the port's ``init`` at seed 0 and the batches come from
``numpy.random.default_rng(1)``.  JAX runs in a subprocess with 4 forced
host devices on a ``(2, 2)`` ``("data", "model")`` mesh with Auto axes,
beside one spawn of the port's 4 ranks on the host-staged group
(``torch_spmd_ranks.run_case_ranks``).

Tolerances, each over the gap measured here (the largest on any rank,
step or leaf): losses and ``grad_norm`` at rtol 1e-5 a step (measured:
1.2e-7 and 1.1e-6, the xLSTM's ``grad_norm``); every shard of the
parameters and of the Adafactor state after each step by mesh position,
its shape and index exact, its values at atol 1e-6 (measured: 4.8e-7,
zamba2's ``dt_bias``), but the sLSTM bias ``b``: its update is rounding
noise (its input-gate row has a gradient of zero in exact arithmetic;
``test_torch_spmd_xlstm`` shows JAX's own two layouts parting there by
1.3e-2), so it is held as that file holds it: the other gates' moves up
to one scale within 1e-4 of the largest move (measured: 3.5e-5 at a
scale of 1.13), every entry within lr × sqrt(size) (measured: 0.37 of
it), each side's update of root mean square lr at most.  For the same
reason the xLSTM case runs one step: the noise reaches every leaf in
step 2.  The port's own unsharded step's losses at rel 1e-6 (measured:
7.6e-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks as ranks  # noqa: E402

CASES = ranks.SEQPAR_FAMILY_CASES
BATCH = 4
STEP_RTOL = 1e-5
SHARD_ATOL = 1e-6
UNSHARDED_RTOL = 1e-6
LR = 1e-3                        # Adafactor's, in the JAX script too
NOISE_CASE, NOISE_LEAF = "xlstm-seqpar", "groups/s/slstm/b"
TIMEOUT = 240
SEQUENCE_SHARDED = [("S(0)", "S(1)")]
STEPS = [(c, i) for c in CASES for i in range(CASES[c]["steps"])]


@pytest.fixture(scope="module")
def runs():
    return ranks.case_runs(CASES, BATCH)


@pytest.fixture(scope="module")
def both(runs, tmp_path_factory):
    return ranks.cases_both(CASES, runs,
                            tmp_path_factory.mktemp("spmd_seqpar_families"),
                            TIMEOUT)


def test_the_cases_are_the_cut_families():
    cfgs = {name: ranks.case_cfg(case) for name, case in CASES.items()}
    assert cfgs["zamba2-seqpar"] == ranks.hybrid_cfg()
    assert cfgs["xlstm-seqpar"] == ranks.xlstm_cfg()
    assert {c["set"] for c in CASES.values()} == {"seqpar"}


@pytest.mark.parametrize("case,step", STEPS)
def test_losses_and_grad_norm_match_jax(both, case, step):
    jax_run, port = both
    for res in port:
        got = res["train"][case]
        np.testing.assert_allclose(got["losses"][step],
                                   jax_run[f"{case}/loss{step}"],
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(got["grad_norms"][step],
                                   jax_run[f"{case}/grad_norm{step}"],
                                   rtol=STEP_RTOL)


@pytest.mark.parametrize("case,step", STEPS)
def test_every_shard_matches_jax(both, case, step):
    """Every leaf of the parameters and the Adafactor state after each
    step, shard for shard by mesh position (shape, index and values); the
    values of the sLSTM bias are held by the test below."""
    jax_run, port = both
    ranks.case_shards_match(jax_run, port, case, step, SHARD_ATOL,
                            skip=(NOISE_LEAF,) if case == NOISE_CASE else ())


def test_slstm_bias_update_is_an_adafactor_step(both, runs):
    """The sLSTM bias after step 1, the port's (from its ranks' shards)
    against JAX's: the moves of the rows whose gradient is not noise (the
    z, f and o gates) agree up to one scale within 1e-4 of the largest
    move; every entry within lr × sqrt(leaf size); each side's update of
    root mean square above 0 and at most lr."""
    jax_run, port = both
    init = runs[NOISE_CASE]["params"]["groups"]["s"]["slstm"]["b"]
    got, want = np.zeros_like(init), np.zeros_like(init)
    for rank, res in enumerate(port):
        sh = res["train"][NOISE_CASE]["step_shards"][0]["param/" + NOISE_LEAF]
        sl = tuple(slice(o, o + n) for o, n in zip(sh["offset"], sh["shape"]))
        got[sl] = sh["values"]
        want[sl] = jax_run[f"{NOISE_CASE}/shard0/param/{NOISE_LEAF}@{rank}"]
    rows = np.ones(init.shape, dtype=bool)
    rows[:, 1] = False                                   # the input gate
    d_t, d_j = (got - init)[rows], (want - init)[rows]
    scale = float((d_t * d_j).sum() / (d_j * d_j).sum())
    assert np.abs(d_t - scale * d_j).max() <= 1e-4 * np.abs(d_j).max()
    assert np.abs(got - want).max() <= LR * np.sqrt(init.size)
    for new in (got, want):
        rms = float(np.sqrt(np.mean(np.square(new - init))))
        assert 0.0 < rms <= LR * (1 + 1e-5), rms


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
    step, on every rank (after each hybrid or xLSTM group and the
    embedding), is placed (Shard(0), Shard(1))."""
    _, port = both
    for res in port:
        assert res["train"][case]["residual"] == \
            [SEQUENCE_SHARDED] * CASES[case]["steps"]
