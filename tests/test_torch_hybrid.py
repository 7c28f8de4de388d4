"""The port's hybrid family (zamba2: Mamba2 blocks with alternating shared
attention + MLP blocks) against the JAX package, on the same weights, on
the CPU: ``causal_lm``'s ``init``, ``count_params``, ``forward``,
``train_loss`` and gradients (with and without remat), ``cache_init``,
``prefill`` / ``decode_step``, the step builders, and the stage splitter's
refusal.

Weights are made by the JAX package and carried across with
``from_numpy_tree``.  Logits, losses and caches are held at rtol 1e-5,
atol 1e-5 (the frameworks sum in other orders, and the chunked SSD sums a
cumulative decay), gradients at rtol 1e-4, atol 1e-6, a decode step
against the port's own forward at atol 1e-4 (the recurrence against the
chunked form, as in ``tests/test_torch_ssm.py``).  ``count_params`` and
the key paths and shapes are exact.  Decoding is teacher-forced on JAX's
greedy tokens.  Every sequence is a multiple of the config's
``ssm_chunk``, which both packages require.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import resolve as j_resolve  # noqa: E402
from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro.serving import stages as j_stages  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.core.opgraph import tree_leaves  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.models import causal_lm as t_lm  # noqa: E402
from repro_torch.serving import stages as t_stages  # noqa: E402
from test_torch_models import CPU, _assert_trees_close, _np_tree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
REF_ATOL = 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# zamba2-smoke (2 groups of 2, two shared blocks, no tail) and a config
# with a tail, one shared block without its MLP, GQA and a padded vocab
TAIL = dict(name="hy-tail", family="hybrid", n_layers=5, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=0, vocab=97,
            vocab_pad_to=64, ssm_state=8, ssm_head_dim=16, ssm_chunk=4,
            attn_every=2, n_shared_attn=1)
HYBRIDS = ["zamba2-7b", "hy-tail"]


def _hy_cfgs(name):
    if name == "hy-tail":
        return JModelCfg(**TAIL), TModelCfg(**TAIL)
    return j_resolve(name).smoke, t_resolve(name).smoke


@functools.lru_cache(maxsize=None)
def _hy(name):
    """(JAX cfg, port cfg, JAX weights, the same weights in the port); made
    once a name (no test writes into them)."""
    cfg_j, cfg_t = _hy_cfgs(name)
    pj = j_lm.init(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, from_numpy_tree(_np_tree(pj), CPU)


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """JAX's loss and gradients on ``_batch(S=8, seed=1)``; ``jax.checkpoint``
    leaves both as they are, so the remat cases are held against these."""
    cfg_j, _, pj, _ = _hy(name)
    bj, _ = _batch(cfg_j, S=8, seed=1)
    (lj, _), gj = jax.value_and_grad(
        lambda p: j_lm.train_loss(cfg_j, p, bj), has_aux=True)(pj)
    return lj, gj


def _batch(cfg, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_init_key_paths_shapes_and_count(name):
    cfg_j, cfg_t, pj, _ = _hy(name)
    pt = t_lm.init(cfg_t, torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
    assert shapes(to_numpy_tree(pt)) == shapes(_np_tree(pj))
    assert [s._asdict() for s in t_lm.segments(cfg_t)] == \
        [s._asdict() for s in j_lm.segments(cfg_j)]
    n = sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(pj))
    assert t_lm.count_params(cfg_t) == j_lm.count_params(cfg_j) == n == \
        sum(t.numel() for t in tree_leaves(pt))
    # layers (inner and outer) and shared blocks are drawn apart
    w = pt["groups"]["mamba"]["in_proj"]["w"]
    assert not torch.equal(w[0, 0], w[0, 1])
    assert not torch.equal(w[0, 0], w[1, 0])
    if cfg_t.n_shared_attn > 1:
        wq = pt["shared_attn"]["attn"]["wq"]["w"]
        assert not torch.equal(wq[0], wq[1])


def test_zamba2_full_count_params_equals_jax():
    assert t_lm.count_params(t_resolve("zamba2-7b").full) == \
        j_lm.count_params(j_resolve("zamba2-7b").full) == 6_956_658_896
    segs = t_lm.segments(t_resolve("zamba2-7b").full)
    assert [(s.name, s.kind, s.count, s.inner) for s in segs] == \
        [("groups", "zamba_group", 13, 6), ("tail", "mamba", 3, 0)]


@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_forward_and_train_loss_match_jax(name):
    cfg_j, cfg_t, pj, pt = _hy(name)
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
    with pytest.raises(ValueError, match="not divisible by chunk"):
        t_lm.forward(cfg_t, pt, bt["tokens"][:, :cfg_t.ssm_chunk + 1])


@pytest.mark.parametrize("remat,policy", [(False, "nothing"),
                                          (True, "nothing"), (True, "dots")])
@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_grads_match_jax(name, remat, policy):
    cfg_j, cfg_t, _, pt = _hy(name)
    cfg_t = cfg_t.replace(remat=remat, remat_policy=policy)
    _, bt = _batch(cfg_j, S=8, seed=1)
    lj, gj = _jax_grads(name)
    lt, _, gt = t_steps.loss_and_grad(cfg_t, pt, bt)
    _close(lt, lj)
    _assert_trees_close(gt, gj, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # every shared block gets a gradient (n_shared_attn=1: from each group)
    assert bool((gt["shared_attn"]["attn"]["wq"]["w"].flatten(1).abs()
                 .sum(1) > 0).all())
    # the gspmd train step takes the hybrid too (out of place: the cached
    # weights stay as they are)
    from repro_torch.optim import sgd
    opt = sgd(0.1)
    new, _, metrics = t_steps.make_train_step(cfg_t, opt, grad_clip=0.0)(
        pt, opt.init(pt), bt)
    assert float(metrics["loss"]) == float(lt)
    old_w = pt["groups"]["mamba"]["in_proj"]["w"]
    assert not torch.equal(new["groups"]["mamba"]["in_proj"]["w"], old_w)


@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_cache_init_matches_jax_and_decodes(name):
    cfg_j, cfg_t, pj, pt = _hy(name)
    cj = j_lm.cache_init(cfg_j, 2, 12)
    ct = t_lm.cache_init(cfg_t, 2, 12, device=CPU)
    _assert_trees_close(ct, cj, rtol=0, atol=0)
    assert ct["pos"].dtype == torch.int32 and ct["pos"].dim() == 0
    tok = np.array([[3], [5]], np.int32)
    lj, cj = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
    lt, ct = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
    _close(lt, lj)
    _assert_trees_close(ct, cj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_prefill_and_decode_match_jax(name):
    """prefill + 4 decode steps, teacher-forced on JAX's greedy tokens:
    logits and every cache leaf at each step."""
    cfg_j, cfg_t, pj, pt = _hy(name)
    B, S, cache_len = 2, 2 * cfg_j.ssm_chunk, 24
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab, (B, S)).astype(np.int32)
    lj, cj = j_lm.prefill(cfg_j, pj, jnp.asarray(toks), cache_len=cache_len)
    lt, ct = t_lm.prefill(cfg_t, pt, torch.from_numpy(toks),
                          cache_len=cache_len)
    assert ct["pos"].dtype == torch.int32 and int(ct["pos"]) == S
    for step in range(5):
        _close(lt, lj)
        _assert_trees_close(ct, cj, rtol=RTOL, atol=ATOL)
        if step == 4:
            break
        tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
        before = to_numpy_tree(ct)
        lj, cj = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
        lt, ct2 = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
        _assert_trees_close(ct, before, rtol=0, atol=0)   # left as it was
        ct = ct2
        assert int(ct["pos"]) == S + step + 1
    with pytest.raises(ValueError, match="not divisible by chunk"):
        t_lm.prefill(cfg_t, pt, torch.from_numpy(toks[:, :S - 1]),
                     cache_len=cache_len)


@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_decode_logits_equal_own_forward(name):
    _, cfg, _, pt = _hy(name)
    S0, S = cfg.ssm_chunk, 3 * cfg.ssm_chunk
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, S)).astype(np.int64))
    full, _ = t_lm.forward(cfg, pt, toks)
    logits, cache = t_lm.prefill(cfg, pt, toks[:, :S0], cache_len=S)
    _close(logits, full[:, S0 - 1:S0])
    assert logits.is_inference() and cache["groups"]["h"].is_inference()
    for pos in range(S0, S):
        logits, cache = t_lm.decode_step(cfg, pt, cache,
                                         toks[:, pos:pos + 1])
        _close(logits, full[:, pos:pos + 1], rtol=0, atol=REF_ATOL)


@pytest.mark.parametrize("name", HYBRIDS)
def test_hybrid_prefill_and_decode_steps_match_jax(name):
    cfg_j, cfg_t, pj, pt = _hy(name)
    S = cfg_j.ssm_chunk
    toks = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (2, S)).astype(np.int32)
    lj, cj = j_steps.make_prefill_step(cfg_j, 2 * S)(
        pj, {"tokens": jnp.asarray(toks)})
    lt, ct = t_steps.make_prefill_step(cfg_t, 2 * S)(
        pt, {"tokens": torch.from_numpy(toks)})
    _close(lt, lj)
    for _ in range(2):
        tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
        lj, cj = j_steps.make_decode_step(cfg_j)(pj, cj, jnp.asarray(tok))
        lt, ct = t_steps.make_decode_step(cfg_t)(pt, ct,
                                                 torch.from_numpy(tok))
        _close(lt, lj)
        _assert_trees_close(ct, cj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", HYBRIDS)
def test_split_stages_refuses_hybrid_as_jax_does(name):
    cfg_j, cfg_t = _hy_cfgs(name)
    with pytest.raises(ValueError) as ej:
        j_stages.split_stages(cfg_j, 2)
    with pytest.raises(ValueError) as et:
        t_stages.split_stages(cfg_t, 2)
    assert str(et.value) == str(ej.value)
    assert "'hybrid'" in str(et.value)
