"""The port's xLSTM family (groups of mLSTM blocks, each followed by an sLSTM
block, then a tail of mLSTM blocks) against the JAX package, on the same
weights, on the CPU: ``causal_lm``'s ``init``, ``count_params``,
``forward``, ``train_loss`` and gradients (with and without remat),
``cache_init``, ``prefill`` / ``decode_step``, the step builders, the stage
splitter's refusal, and the reference's short-prompt fault, which the port
mirrors.

Weights are made by the JAX package and carried across with
``from_numpy_tree``.  Logits and losses are held at rtol 1e-5, atol 1e-5
(the frameworks sum in other orders, and the mLSTM's parallel form sums a
cumulative log-decay), gradients at rtol 1e-4, atol 1e-6, a decode step
against the port's own forward at atol 1e-4 (the recurrence against the
parallel form, as in ``tests/test_torch_xlstm.py``).  ``count_params``,
the key paths and shapes and an empty cache are exact.  Decoding is
teacher-forced on JAX's greedy tokens.

Two tolerances are looser, each where a float64 run of the port shows both
packages' fp32 results as far from it as from each other (summation order,
not a fault of either):
- a cache leaf at rtol 1e-5 and atol 1e-5 times its largest |value| (at
  least 1): the recurrent states (C, n, the sLSTM's c and n) are running
  sums that reach 3-7 here.  On xl-tail the packages part by 2.0e-5 on a
  tail ``C`` whose entries reach 5.3, each 1.3-1.7e-5 from float64; on
  xl-g3 by 5.0e-5 on an sLSTM ``n`` reaching 6.7, each 3-4.6e-4 from it;
- the embedding table's gradient at atol 5e-5: it passes through the first
  norm over embeddings drawn at 0.02 (a gain of ~50) and every layer's
  backward, reaching 3.3; the packages part by 1.1e-5 (xlstm-smoke) and
  2.1e-5 (xl-tail), each 1.2e-5 and 2.6e-5 from float64.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import resolve as j_resolve  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro.serving import stages as j_stages  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core.opgraph import tree_leaves  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.models import causal_lm as t_lm  # noqa: E402
from repro_torch.serving import stages as t_stages  # noqa: E402
from test_torch_models import CPU, _assert_trees_close, _np_tree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
EMBED_GRAD_ATOL = 5e-5
REF_ATOL = 1e-4

# xlstm-smoke (2 groups of one mLSTM + one sLSTM, no tail); the same with 5
# layers (an mlstm tail, which the full config never reaches); and 2 groups
# of two mLSTM blocks + one sLSTM, a tail, and a padded vocabulary
VARIANTS = {"xl-tail": dict(name="xl-tail", n_layers=5),
            "xl-g3": dict(name="xl-g3", n_layers=7, slstm_every=3,
                          d_model=64, vocab=97, vocab_pad_to=64)}
XLSTMS = ["xlstm-1_3b", "xl-tail", "xl-g3"]


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _cache_close(t_cache, j_cache):
    """Leaf by leaf at rtol 1e-5, atol 1e-5 times the leaf's largest |value|
    (at least 1); the key paths must be the same."""
    t_np, j_np = to_numpy_tree(t_cache), _np_tree(j_cache)
    assert jax.tree_util.tree_structure(t_np) == \
        jax.tree_util.tree_structure(j_np)
    for a, b in zip(jax.tree_util.tree_leaves(t_np),
                    jax.tree_util.tree_leaves(j_np)):
        scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
        _close(a, b, atol=ATOL * scale)


def _xl_cfgs(name):
    if name in VARIANTS:
        return (j_resolve("xlstm-1_3b").smoke.replace(**VARIANTS[name]),
                t_resolve("xlstm-1_3b").smoke.replace(**VARIANTS[name]))
    return j_resolve(name).smoke, t_resolve(name).smoke


@functools.lru_cache(maxsize=None)
def _xl(name):
    """(JAX cfg, port cfg, JAX weights, the same weights in the port); made
    once a name (no test writes into them)."""
    cfg_j, cfg_t = _xl_cfgs(name)
    pj = j_lm.init(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, from_numpy_tree(_np_tree(pj), CPU)


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """JAX's loss and gradients on ``_batch(S=8, seed=1)``; ``jax.checkpoint``
    leaves both as they are, so the remat cases are held against these."""
    cfg_j, _, pj, _ = _xl(name)
    bj, _ = _batch(cfg_j, S=8, seed=1)
    (lj, _), gj = jax.value_and_grad(
        lambda p: j_lm.train_loss(cfg_j, p, bj), has_aux=True)(pj)
    return lj, gj


def _batch(cfg, B=2, S=12, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("name", XLSTMS)
def test_xlstm_init_key_paths_shapes_and_count(name):
    cfg_j, cfg_t, pj, _ = _xl(name)
    pt = t_lm.init(cfg_t, torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
    assert shapes(to_numpy_tree(pt)) == shapes(_np_tree(pj))
    assert [s._asdict() for s in t_lm.segments(cfg_t)] == \
        [s._asdict() for s in j_lm.segments(cfg_j)]
    n = sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(pj))
    assert t_lm.count_params(cfg_t) == j_lm.count_params(cfg_j) == n == \
        sum(t.numel() for t in tree_leaves(pt))
    assert pt["groups"]["m"]["mlstm"]["f_bias"].dtype == torch.float32
    # layers (inner and outer) are drawn apart
    w = pt["groups"]["m"]["mlstm"]["up"]["w"]
    assert not torch.equal(w[0, 0], w[1, 0])
    if w.shape[1] > 1:
        assert not torch.equal(w[0, 0], w[0, 1])
    r = pt["groups"]["s"]["slstm"]["r"]
    assert not torch.equal(r[0], r[1])


def test_xlstm_full_count_params_equals_jax():
    assert t_lm.count_params(t_resolve("xlstm-1_3b").full) == \
        j_lm.count_params(j_resolve("xlstm-1_3b").full) == 2_021_890_216
    assert t_resolve("xlstm-1.3b") is t_resolve("xlstm-1_3b")
    segs = t_lm.segments(t_resolve("xlstm-1_3b").full)
    assert [(s.name, s.kind, s.count, s.inner) for s in segs] == \
        [("groups", "xlstm_group", 6, 8)]


@pytest.mark.parametrize("name", XLSTMS)
def test_xlstm_forward_and_train_loss_match_jax(name):
    cfg_j, cfg_t, pj, pt = _xl(name)
    bj, bt = _batch(cfg_j)
    lj, aj = j_lm.forward(cfg_j, pj, bj["tokens"])
    lt, at = t_lm.forward(cfg_t, pt, bt["tokens"])
    assert lt.shape == lj.shape
    _close(lt, lj)
    assert float(at) == float(aj) == 0.0
    if cfg_t.vocab_padded != cfg_t.vocab:
        assert bool((lt[..., cfg_t.vocab:] == -1e30).all())
    (Lj, mj), (Lt, mt) = (j_lm.train_loss(cfg_j, pj, bj),
                          t_lm.train_loss(cfg_t, pt, bt))
    for a, b in ((Lt, Lj), (mt["ce"], mj["ce"])):
        _close(a, b)


@pytest.mark.parametrize("remat,policy", [(False, "nothing"),
                                          (True, "nothing"), (True, "dots")])
@pytest.mark.parametrize("name", ["xlstm-1_3b", "xl-tail"])
def test_xlstm_grads_match_jax(name, remat, policy):
    cfg_j, cfg_t, _, pt = _xl(name)
    cfg_t = cfg_t.replace(remat=remat, remat_policy=policy)
    _, bt = _batch(cfg_j, S=8, seed=1)
    lj, gj = _jax_grads(name)
    lt, _, gt = t_steps.loss_and_grad(cfg_t, pt, bt)
    _close(lt, lj)
    _assert_trees_close({k: v for k, v in gt.items() if k != "embed"},
                        {k: v for k, v in gj.items() if k != "embed"},
                        rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _close(gt["embed"]["table"], gj["embed"]["table"], rtol=GRAD_RTOL,
           atol=EMBED_GRAD_ATOL)
    # every layer's recurrent weights get a gradient
    assert bool((gt["groups"]["s"]["slstm"]["r"].flatten(1).abs().sum(1)
                 > 0).all())
    # the gspmd train step takes the xLSTM too (out of place: the cached
    # weights stay as they are)
    from repro_torch.optim import sgd
    opt = sgd(0.1)
    new, _, metrics = t_steps.make_train_step(cfg_t, opt, grad_clip=0.0)(
        pt, opt.init(pt), bt)
    assert float(metrics["loss"]) == float(lt)
    old_w = pt["groups"]["m"]["mlstm"]["up"]["w"]
    assert not torch.equal(new["groups"]["m"]["mlstm"]["up"]["w"], old_w)


@pytest.mark.parametrize("name", XLSTMS)
def test_xlstm_cache_init_matches_jax_and_decodes(name):
    cfg_j, cfg_t, pj, pt = _xl(name)
    cj = j_lm.cache_init(cfg_j, 2, 12)
    ct = t_lm.cache_init(cfg_t, 2, 12, device=CPU)
    _assert_trees_close(ct, cj, rtol=0, atol=0)
    assert ct["pos"].dtype == torch.int32 and ct["pos"].dim() == 0
    assert ct["groups"]["m"]["m"].dtype == torch.float32
    assert ct["groups"]["s"]["m"].dtype == torch.float32
    tok = np.array([[3], [5]], np.int32)
    lj, cj = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
    lt, ct = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
    _close(lt, lj)
    _cache_close(ct, cj)


@pytest.mark.parametrize("name", XLSTMS)
def test_xlstm_prefill_and_decode_match_jax(name):
    """prefill + 4 decode steps, teacher-forced on JAX's greedy tokens:
    logits and every cache leaf at each step; the cache a step is given is
    left as it was."""
    cfg_j, cfg_t, pj, pt = _xl(name)
    B, S = 2, 7
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab, (B, S)).astype(np.int32)
    lj, cj = j_lm.prefill(cfg_j, pj, jnp.asarray(toks))
    lt, ct = t_lm.prefill(cfg_t, pt, torch.from_numpy(toks))
    assert ct["pos"].dtype == torch.int32 and int(ct["pos"]) == S
    for step in range(5):
        _close(lt, lj)
        _cache_close(ct, cj)
        if step == 4:
            break
        tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
        before = to_numpy_tree(ct)
        lj, cj = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
        lt, ct2 = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
        _assert_trees_close(ct, before, rtol=0, atol=0)   # left as it was
        ct = ct2
        assert int(ct["pos"]) == S + step + 1


@pytest.mark.parametrize("name", XLSTMS)
def test_xlstm_decode_logits_equal_own_forward(name):
    _, cfg, _, pt = _xl(name)
    S0, S = 4, 12
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, S)).astype(np.int64))
    full, _ = t_lm.forward(cfg, pt, toks)
    logits, cache = t_lm.prefill(cfg, pt, toks[:, :S0])
    _close(logits, full[:, S0 - 1:S0])
    assert logits.is_inference() and cache["groups"]["m"]["C"].is_inference()
    for pos in range(S0, S):
        logits, cache = t_lm.decode_step(cfg, pt, cache,
                                         toks[:, pos:pos + 1])
        _close(logits, full[:, pos:pos + 1], rtol=0, atol=REF_ATOL)


@pytest.mark.parametrize("name", XLSTMS)
def test_xlstm_prefill_and_decode_steps_match_jax(name):
    cfg_j, cfg_t, pj, pt = _xl(name)
    toks = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (2, 5)).astype(np.int32)
    lj, cj = j_steps.make_prefill_step(cfg_j, 16)(
        pj, {"tokens": jnp.asarray(toks)})
    lt, ct = t_steps.make_prefill_step(cfg_t, 16)(
        pt, {"tokens": torch.from_numpy(toks)})
    _close(lt, lj)
    for _ in range(2):
        tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
        lj, cj = j_steps.make_decode_step(cfg_j)(pj, cj, jnp.asarray(tok))
        lt, ct = t_steps.make_decode_step(cfg_t)(pt, ct,
                                                 torch.from_numpy(tok))
        _close(lt, lj)
        _cache_close(ct, cj)


@pytest.mark.parametrize("name", XLSTMS)
def test_split_stages_refuses_xlstm_as_jax_does(name):
    cfg_j, cfg_t = _xl_cfgs(name)
    for fn_j, fn_t in ((j_stages.split_stages, t_stages.split_stages),
                       (lambda c, _: j_stages.check_shardable(c),
                        lambda c, _: t_stages.check_shardable(c))):
        with pytest.raises(ValueError) as ej:
            fn_j(cfg_j, 2)
        with pytest.raises(ValueError) as et:
            fn_t(cfg_t, 2)
        assert str(et.value) == str(ej.value)
        assert "'xlstm'" in str(et.value)


@pytest.mark.parametrize("prompt", [1, 2])
def test_short_prompt_decode_fails_in_both_packages(prompt):
    """A fault of the reference that the port mirrors: ``mlstm_prefill``
    keeps ``xm[:, S - (W-1):]`` as the conv tail, so a prompt shorter than
    ``W - 1 = 3`` tokens leaves a tail of 1 row instead of 3, and the first
    decode step's conv (``causal_conv1d_step``) raises in both packages.
    The port does not pad the tail behind the caller's back."""
    cfg_j, cfg_t, pj, pt = _xl("xlstm-1_3b")
    toks = np.arange(1, 2 * prompt + 1, dtype=np.int32).reshape(2, prompt)
    _, cj = j_lm.prefill(cfg_j, pj, jnp.asarray(toks))
    _, ct = t_lm.prefill(cfg_t, pt, torch.from_numpy(toks))
    tail = (cfg_j.n_layers // cfg_j.slstm_every, 1, 2, 1,
            2 * cfg_j.d_model)
    assert np.shape(cj["groups"]["m"]["conv"]) == tail
    assert tuple(ct["groups"]["m"]["conv"].shape) == tail
    tok = toks[:, :1]
    with pytest.raises(ValueError, match="Size of label 'w' for operand 1 "
                       r"\(2\) does not match previous terms \(4\)"):
        j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
    with pytest.raises(RuntimeError, match="einsum\\(\\): subscript w has "
                       "size 4 for operand 1 which does not broadcast with "
                       "previously seen size 2"):
        t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
    # three tokens fill the tail, and decoding goes on in both
    toks = np.arange(1, 7, dtype=np.int32).reshape(2, 3)
    _, cj = j_lm.prefill(cfg_j, pj, jnp.asarray(toks))
    _, ct = t_lm.prefill(cfg_t, pt, torch.from_numpy(toks))
    lj, _ = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, :1]))
    lt, _ = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(toks[:, :1]))
    _close(lt, lj)
