"""The port's decode path against the JAX package, on the same weights, on
the CPU: ``attn_prefill`` / ``attn_decode``, ``causal_lm.prefill`` /
``decode_step`` / ``cache_init`` (dense and moe, the smoke variants of
deepseek-moe-16b and mixtral-8x7b among them; ``tests/test_torch_zoo.py``
runs the other dense configs' smoke variants through the same checks),
the moe family's ``forward`` and ``train_loss``, and the step builders.
The hybrid family's decode path is held in ``tests/test_torch_hybrid.py``.

Logits are held at rtol 1e-5, atol 1e-6 (the frameworks sum in other
orders); the caches hold keys and values of unit scale, deep in the stack,
at rtol 1e-5, atol 1e-5.  Decoding is teacher-forced on JAX's greedy
tokens, so a near-tie cannot send the two packages down different
sequences.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro.models import encdec as j_ed  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import causal_lm as t_lm  # noqa: E402
from test_torch_causal_lm import _cfgs  # noqa: E402
from test_torch_models import (ATOL, CPU, RTOL, _assert_trees_close,  # noqa: E402
                               _np_tree)

MOE = dict(name="serve-moe", family="moe", n_layers=4, d_model=48,
           n_heads=4, n_kv_heads=2, d_ff=64, vocab=89, n_experts=4, top_k=2,
           tie_embeddings=True)


def _moe_cfgs(**kw):
    return JModelCfg(**{**MOE, **kw}), TModelCfg(**{**MOE, **kw})


def _cfg_pair(name):
    if name == "moe":
        return _moe_cfgs()
    if name == "moe-top3-shared-window":
        return _moe_cfgs(top_k=3, n_shared_experts=1, window=4,
                         moe_impl="capacity", capacity_factor=4.0)
    return _cfgs(name)


CACHE_ATOL = 1e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _cache_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=CACHE_ATOL)


# ------------------------------------------------------------- attention --
@pytest.mark.parametrize("n_kv,rope,window,S,cache_len", [
    (2, 1.0, None, 5, 12),     # GQA, RoPE, cache longer than the prompt
    (4, 0.0, None, 6, 6),      # MHA, no RoPE, cache exactly the prompt
    (1, 0.5, 3, 7, 10),        # MQA, partial RoPE, sliding window
])
def test_attn_prefill_and_decode_match_jax(n_kv, rope, window, S, cache_len):
    B, d, H, hd = 2, 32, 4, 8
    pj = j_attn.attn_init(jax.random.PRNGKey(0), d, H, n_kv, hd)
    pt = from_numpy_tree(_np_tree(pj), CPU)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S + 3, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=n_kv, head_dim=hd, window=window,
              rope_fraction=rope)
    yj, cj = j_attn.attn_prefill(pj, jnp.asarray(x[:, :S]),
                                 cache_len=cache_len, **kw)
    yt, ct = t_attn.attn_prefill(pt, torch.from_numpy(x[:, :S]),
                                 cache_len=cache_len, **kw)
    assert isinstance(ct, t_attn.KVCache)
    assert ct.k.shape == (B, cache_len, n_kv, hd)
    _close(yt, yj)
    _cache_close(ct.k, cj.k)
    _cache_close(ct.v, cj.v)
    for i in range(min(3, cache_len - S)):
        pos = S + i
        before = (ct.k.clone(), ct.v.clone())
        step = x[:, pos:pos + 1]
        yj, cj = j_attn.attn_decode(pj, jnp.asarray(step), cj,
                                    jnp.asarray(pos, jnp.int32), **kw)
        yt, ct2 = t_attn.attn_decode(pt, torch.from_numpy(step), ct,
                                     torch.tensor(pos, dtype=torch.int32),
                                     **kw)
        # functional: the caller's cache is unchanged
        assert torch.equal(ct.k, before[0]) and torch.equal(ct.v, before[1])
        ct = ct2
        _close(yt, yj)
        _cache_close(ct.k, cj.k)
        _cache_close(ct.v, cj.v)


def test_make_mask_takes_the_device_of_its_caller():
    with pytest.raises(TypeError):
        t_attn.make_mask(4, 4, True, None)      # no default device
    m = t_attn.make_mask(4, 6, True, 2, q_offset=2, device=CPU)
    want = j_attn.make_mask(4, 6, True, 2, q_offset=2)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want))


# --------------------------------------------------------------- the LM --
def _lm(name, batch=2, seed=0):
    cfg_j, cfg_t = _cfg_pair(name)
    pj = j_lm.init(cfg_j, jax.random.PRNGKey(seed))
    pt = from_numpy_tree(_np_tree(pj), CPU)
    return cfg_j, cfg_t, pj, pt


LMS = ["gpt2-xl", "llama3-8b", "moe", "moe-top3-shared-window",
       "deepseek-moe-16b", "mixtral-8x7b"]


@pytest.mark.parametrize("name", LMS)
def test_prefill_and_decode_match_jax(name):
    check_prefill_and_decode_match_jax(name)


def check_prefill_and_decode_match_jax(name):
    """prefill + 4 decode steps, teacher-forced on JAX's greedy tokens:
    logits and every cache leaf at each step."""
    cfg_j, cfg_t, pj, pt = _lm(name)
    B, S, cache_len = 2, 6, 12
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab, (B, S)).astype(np.int32)
    lj, cj = j_lm.prefill(cfg_j, pj, jnp.asarray(toks), cache_len=cache_len)
    lt, ct = t_lm.prefill(cfg_t, pt, torch.from_numpy(toks),
                          cache_len=cache_len)
    assert ct["pos"].dtype == torch.int32 and ct["pos"].dim() == 0
    for step in range(5):
        _close(lt, lj)
        _assert_trees_close(ct, cj, atol=CACHE_ATOL)
        if step == 4:
            break
        tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
        lj, cj = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
        lt, ct = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
        assert int(ct["pos"]) == S + step + 1


@pytest.mark.parametrize("name", LMS)
def test_decode_logits_equal_own_forward(name):
    check_decode_logits_equal_own_forward(name)


def check_decode_logits_equal_own_forward(name):
    """Every decode step's logits equal the full-sequence forward's at that
    position; the input cache is left as it was."""
    _, cfg, _, pt = _lm(name)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 9)).astype(np.int64))
    full, _ = t_lm.forward(cfg, pt, toks)
    logits, cache = t_lm.prefill(cfg, pt, toks[:, :4], cache_len=9)
    torch.testing.assert_close(logits, full[:, 3:4], rtol=RTOL, atol=ATOL)
    for pos in range(4, 9):
        before = to_numpy_tree(cache)
        logits, new = t_lm.decode_step(cfg, pt, cache, toks[:, pos:pos + 1])
        _assert_trees_close(cache, before, rtol=0, atol=0)
        torch.testing.assert_close(logits, full[:, pos:pos + 1], rtol=RTOL,
                                   atol=ATOL)
        cache = new


def test_prefill_and_decode_run_in_inference_mode():
    _, cfg, _, pt = _lm("llama3-8b")
    logits, cache = t_lm.prefill(cfg, pt, torch.zeros(1, 3, dtype=torch.long),
                                 cache_len=5)
    assert logits.is_inference() and cache["blocks"]["k"].is_inference()
    logits, cache = t_lm.decode_step(cfg, pt, cache,
                                     torch.zeros(1, 1, dtype=torch.long))
    assert logits.is_inference() and not torch.is_inference_mode_enabled()


@pytest.mark.parametrize("name", ["gpt2-xl", "moe"])
def test_cache_init_matches_jax_and_decodes(name):
    cfg_j, cfg_t, pj, pt = _lm(name)
    cj = j_lm.cache_init(cfg_j, 2, 7)
    ct = t_lm.cache_init(cfg_t, 2, 7, device=CPU)
    _assert_trees_close(ct, cj, rtol=0, atol=0)
    assert ct["pos"].dtype == torch.int32
    tok = np.array([[3], [5]], np.int32)
    lj, _ = j_lm.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
    lt, _ = t_lm.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
    _close(lt, lj)


def test_unported_families_raise_naming_the_roadmap():
    """No family raises any more.  The xLSTM family (ported in Q1.3b; held
    in full in ``tests/test_torch_xlstm_lm.py``) builds its cache and
    prefills as the JAX package does.  The encoder-decoder (Q1.3c; held in
    full in ``tests/test_torch_encdec.py``) is served through the step
    builders as in JAX, with JAX's logits and cache, and ``causal_lm``
    refuses it with JAX's ``ValueError``."""
    kw = dict(name="xl", family="xlstm", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=0, vocab=64, slstm_every=2)
    xl_j, xl_t = JModelCfg(**kw), TModelCfg(**kw)
    _assert_trees_close(t_lm.cache_init(xl_t, 1, 8, device=CPU),
                        j_lm.cache_init(xl_j, 1, 8), rtol=0, atol=0)
    pj = j_lm.init(xl_j, jax.random.PRNGKey(0))
    pt = from_numpy_tree(_np_tree(pj), CPU)
    toks = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    lj, cj = j_lm.prefill(xl_j, pj, jnp.asarray(toks))
    lt, ct = t_lm.prefill(xl_t, pt, torch.from_numpy(toks))
    _close(lt, lj)
    _assert_trees_close(ct, cj, rtol=RTOL, atol=CACHE_ATOL)
    ed = dict(name="ed", family="encdec", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, n_enc_layers=2, d_frontend=32)
    ed_j, ed_t = JModelCfg(**ed), TModelCfg(**ed)
    pj = j_ed.init(ed_j, jax.random.PRNGKey(0))
    pt = from_numpy_tree(_np_tree(pj), CPU)
    src = np.random.default_rng(1).standard_normal(
        (2, 16, 32)).astype(np.float32)
    lj, cj = j_steps.make_prefill_step(ed_j, 8)(
        pj, {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(toks)})
    lt, ct = t_steps.make_prefill_step(ed_t, 8)(
        pt, {"src_embeds": torch.from_numpy(src),
             "tokens": torch.from_numpy(toks)})
    _close(lt, lj)
    _assert_trees_close(ct, cj, rtol=RTOL, atol=CACHE_ATOL)
    tok = np.array([[3], [5]], np.int32)
    lj, cj = j_steps.make_decode_step(ed_j)(pj, cj, jnp.asarray(tok))
    lt, ct = t_steps.make_decode_step(ed_t)(pt, ct, torch.from_numpy(tok))
    _close(lt, lj)
    _assert_trees_close(ct, cj, rtol=RTOL, atol=CACHE_ATOL)
    with pytest.raises(ValueError, match="unknown family 'encdec'"):
        j_lm.cache_init(ed_j, 1, 8)
    with pytest.raises(ValueError, match="unknown family 'encdec'"):
        t_lm.cache_init(ed_t, 1, 8, device=CPU)


# ------------------------------------------------------------ moe family --
@pytest.mark.parametrize("name", ["moe", "moe-top3-shared-window",
                                  "deepseek-moe-16b", "mixtral-8x7b"])
def test_moe_family_forward_and_train_loss_match_jax(name):
    cfg_j, cfg_t, pj, pt = _lm(name)
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
    init_t = t_lm.init(cfg_t, torch.Generator().manual_seed(0))
    assert shapes(to_numpy_tree(init_t)) == shapes(_np_tree(pj))
    assert t_lm.count_params(cfg_t) == j_lm.count_params(cfg_j) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(pj))
    toks = np.random.default_rng(2).integers(
        0, cfg_j.vocab, (2, 9)).astype(np.int32)
    b_j = {"tokens": jnp.asarray(toks[:, :-1]),
           "labels": jnp.asarray(toks[:, 1:])}
    b_t = {"tokens": torch.from_numpy(toks[:, :-1]),
           "labels": torch.from_numpy(toks[:, 1:].copy())}
    lj, aj = j_lm.forward(cfg_j, pj, b_j["tokens"])
    lt, at = t_lm.forward(cfg_t, pt, b_t["tokens"])
    _close(lt, lj)
    assert float(at) > 0
    _close(at, aj)
    (Lj, mj), (Lt, mt) = (j_lm.train_loss(cfg_j, pj, b_j),
                          t_lm.train_loss(cfg_t, pt, b_t))
    for a, b in ((Lt, Lj), (mt["ce"], mj["ce"]), (mt["aux"], mj["aux"])):
        _close(a, b)


def test_moe_family_trains_through_make_train_step():
    """The moe family's gradients (aux loss included) through the port's
    gspmd step against ``jax.grad``."""
    from repro_torch.optim import sgd
    cfg_j, cfg_t, pj, pt = _lm("moe")
    toks = np.random.default_rng(4).integers(
        0, cfg_j.vocab, (2, 7)).astype(np.int32)
    b_j = {"tokens": jnp.asarray(toks[:, :-1]),
           "labels": jnp.asarray(toks[:, 1:])}
    b_t = {"tokens": torch.from_numpy(toks[:, :-1]),
           "labels": torch.from_numpy(toks[:, 1:].copy())}
    (_, _), gj = jax.value_and_grad(
        lambda p: j_lm.train_loss(cfg_j, p, b_j), has_aux=True)(pj)
    loss, _, gt = t_steps.loss_and_grad(cfg_t, pt, b_t)
    _assert_trees_close(gt, gj, rtol=1e-4, atol=1e-6)
    opt = sgd(0.1)
    step = t_steps.make_train_step(cfg_t, opt, grad_clip=0.0)
    _, _, metrics = step(pt, opt.init(pt), b_t)
    assert float(metrics["loss"]) == float(loss)


# ----------------------------------------------------------- step builders --
@pytest.mark.parametrize("name", ["llama3-8b", "moe"])
def test_prefill_and_decode_steps_match_jax(name):
    from repro.distributed import steps as j_steps
    cfg_j, cfg_t, pj, pt = _lm(name)
    toks = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (2, 5)).astype(np.int32)
    lj, cj = j_steps.make_prefill_step(cfg_j, 8)(
        pj, {"tokens": jnp.asarray(toks)})
    lt, ct = t_steps.make_prefill_step(cfg_t, 8)(
        pt, {"tokens": torch.from_numpy(toks)})
    _close(lt, lj)
    tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
    lj, cj = j_steps.make_decode_step(cfg_j)(pj, cj, jnp.asarray(tok))
    lt, ct = t_steps.make_decode_step(cfg_t)(pt, ct, torch.from_numpy(tok))
    _close(lt, lj)
    _assert_trees_close(ct, cj, atol=CACHE_ATOL)
