"""The port's encoder-decoder served, and its step builders, against the
JAX package, on the same weights, on the CPU: ``cache_init``, ``prefill``
and its cache (``pos``, ``k``, ``v``, ``xk``, ``xv``), decode steps with
their caches, decode against the port's own teacher-forced decoder, and
``make_prefill_step`` / ``make_decode_step`` / ``make_train_step``.

The configs (seamless-smoke, and ``ed-pad``: two layers a side with a
padded vocabulary), the JAX weights carried with ``from_numpy_tree`` and
the tolerances are ``tests/test_torch_encdec.py``'s: values at rtol 1e-5,
atol 1e-5; an AdamW update as the gspmd tests hold it; an empty cache
exact.  Decoding is teacher-forced on JAX's greedy tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro.models import encdec as j_ed  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.checkpoint import to_numpy_tree  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.models import encdec as t_ed  # noqa: E402
from repro_torch.models.scan_config import unstack  # noqa: E402
from test_torch_encdec import ATOL, GRAD_ATOL, GRAD_RTOL  # noqa: E402
from test_torch_encdec import NAMES, RTOL, _batch, _close, _ed  # noqa: E402
from test_torch_gspmd import _assert_adamw_params_close  # noqa: E402
from test_torch_models import CPU, _assert_trees_close  # noqa: E402


@pytest.mark.parametrize("name", NAMES)
def test_cache_init_matches_jax(name):
    cfg_j, cfg_t, _, _ = _ed(name)
    cj = j_ed.cache_init(cfg_j, 2, 12, 16)
    ct = t_ed.cache_init(cfg_t, 2, 12, 16, device=CPU)
    _assert_trees_close(ct, cj, rtol=0, atol=0)
    assert ct["pos"].dtype == torch.int32 and ct["pos"].dim() == 0
    assert ct["dec"]["k"].shape == (cfg_t.n_dec_layers, 2, 12,
                                    cfg_t.n_kv_heads, cfg_t.head_dim)
    assert ct["dec"]["xk"].shape[2] == 16
    with pytest.raises(TypeError):
        t_ed.cache_init(cfg_t, 1, 8, 16)    # the caller names the device


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name):
    """prefill (logits and every cache leaf: pos, k, v, xk, xv), then 4
    decode steps teacher-forced on JAX's greedy tokens, the logits and the
    cache at each; a step leaves the cache it was given as it was, and
    passes the cross K/V through."""
    cfg_j, cfg_t, pj, pt = _ed(name)
    bj, bt = _batch(cfg_j, S=5, seed=3)
    lj, cj = j_ed.prefill(cfg_j, pj, bj["src_embeds"], bj["tokens"], 16)
    lt, ct = t_ed.prefill(cfg_t, pt, bt["src_embeds"], bt["tokens"], 16)
    assert lt.shape == lj.shape == (2, 1, cfg_t.vocab_padded)
    assert ct["pos"].dtype == torch.int32 and int(ct["pos"]) == 5
    assert lt.is_inference() and ct["dec"]["k"].is_inference()
    for step in range(5):
        _close(lt, lj)
        _assert_trees_close(ct, cj, rtol=RTOL, atol=ATOL)
        if step == 4:
            break
        tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
        before = to_numpy_tree(ct)
        lj, cj = j_ed.decode_step(cfg_j, pj, cj, jnp.asarray(tok))
        lt, ct2 = t_ed.decode_step(cfg_t, pt, ct, torch.from_numpy(tok))
        _assert_trees_close(ct, before, rtol=0, atol=0)   # left as it was
        assert ct2["dec"]["xk"] is ct["dec"]["xk"]
        assert ct2["dec"]["xv"] is ct["dec"]["xv"]
        ct = ct2
        assert int(ct["pos"]) == 5 + step + 1


@pytest.mark.parametrize("name", NAMES)
def test_decode_logits_equal_own_teacher_forced_forward(name):
    _, cfg, _, pt = _ed(name)
    S0, S = 4, 12
    _, bt = _batch(cfg, S=S, seed=5)
    src, toks = bt["src_embeds"], bt["tokens"]
    memory = t_ed.encode(cfg, pt, src)
    full = t_ed._decoder_train(cfg, pt, toks, memory)
    logits, cache = t_ed.prefill(cfg, pt, src, toks[:, :S0], S)
    _close(logits, full[:, S0 - 1:S0])
    _close(cache["dec"]["xk"][0],
           t_ed._cross_kv(cfg, unstack(pt["dec"])[0], memory)[0])
    for pos in range(S0, S):
        logits, cache = t_ed.decode_step(cfg, pt, cache, toks[:, pos:pos + 1])
        _close(logits, full[:, pos:pos + 1])


@pytest.mark.parametrize("name", NAMES)
def test_step_builders_match_jax(name):
    """``make_prefill_step`` / ``make_decode_step`` take the encdec branch
    and give JAX's logits and cache; two ``make_train_step`` AdamW steps
    give JAX's metrics, and parameters held as the gspmd tests hold an
    AdamW update (all but 1e-4 of the entries within the gradient
    tolerance, every entry within twice the summed learning rate: Adam's
    normalized step turns a last-ulp gradient gap near zero into a full
    step)."""
    cfg_j, cfg_t, pj, pt = _ed(name)
    bj, bt = _batch(cfg_j, S=5, seed=6)
    serve_j = {k: bj[k] for k in ("src_embeds", "tokens")}
    serve_t = {k: bt[k] for k in ("src_embeds", "tokens")}
    lj, cj = j_steps.make_prefill_step(cfg_j, 16)(pj, serve_j)
    lt, ct = t_steps.make_prefill_step(cfg_t, 16)(pt, serve_t)
    _close(lt, lj)
    _assert_trees_close(ct, cj, rtol=RTOL, atol=ATOL)
    tok = np.array(jnp.argmax(lj[:, -1, :], axis=-1))[:, None]
    lj, cj = j_steps.make_decode_step(cfg_j)(pj, cj, jnp.asarray(tok))
    lt, ct = t_steps.make_decode_step(cfg_t)(pt, ct, torch.from_numpy(tok))
    _close(lt, lj)
    _assert_trees_close(ct, cj, rtol=RTOL, atol=ATOL)

    opt_t = t_optim.adamw(1e-3, weight_decay=0.0)
    opt_j = j_optim.adamw(1e-3, weight_decay=0.0)
    step_t = t_steps.make_train_step(cfg_t, opt_t)
    step_j = j_steps.make_train_step(cfg_j, opt_j)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    for seed in (7, 8):
        bj, bt = _batch(cfg_j, S=8, seed=seed)
        pt, st, mt = step_t(pt, st, bt)
        pj, sj, mj = step_j(pj, sj, bj)
        assert set(mt) == set(mj) == {"loss", "grad_norm", "ce", "aux"}
        for k in mt:
            _close(mt[k], mj[k], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _assert_adamw_params_close(pt, pj, lr_sum=2e-3)
