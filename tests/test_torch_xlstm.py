"""The port's xLSTM blocks (mLSTM and sLSTM) against the JAX package, on
the same inputs and weights, on the CPU.  The xLSTM family of the causal LM
built from them is held in ``tests/test_torch_xlstm_lm.py``.

Inputs are drawn with numpy from a seed; weights are made by the JAX
package and carried across with ``from_numpy_tree``.  Tolerances:
- outputs and states at rtol 1e-5, atol 1e-5 (the frameworks sum in other
  orders; the parallel form sums a cumulative log-decay);
- gradients at rtol 1e-4, atol 1e-6, of the mean square of a block's
  output (a loss of O(1), as a training loss is);
- the port's own recurrent decode against its parallel form at atol 1e-4,
  its prefill against the block and the sLSTM scan against stepping at
  atol 1e-5, as in the JAX package's own test
  (``tests/test_models.py::TestXLSTM``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as j_xl  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.models import xlstm as t_xl  # noqa: E402
from test_torch_models import CPU, _assert_trees_close, _np_tree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
REF_ATOL = 1e-4

# the JAX test's config, and one with four heads and a non-multiple-of-64
# sLSTM FFN width (4/3 · 40 = 53 -> 64)
CFGS = {"d16h2": dict(d_model=16, n_heads=2),
        "d40h4": dict(d_model=40, n_heads=4)}


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _cfgs(name):
    return j_xl.XLSTMCfg(**CFGS[name]), t_xl.XLSTMCfg(**CFGS[name])


def _weights(init_j, cfg_j, seed):
    pj = init_j(jax.random.PRNGKey(seed), cfg_j)
    return pj, from_numpy_tree(_np_tree(pj), CPU)


def _x(cfg, B=2, S=10, seed=0, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _shapes(tree):
    """Each leaf's shape and dtype name, for a JAX or a torch tree."""
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


# ------------------------------------------------------------------- init --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_inits_key_paths_shapes_and_fp32_f_bias(name, dtype):
    cfg_j, cfg_t = _cfgs(name)
    gen = torch.Generator().manual_seed(0)
    for init_j, init_t in ((j_xl.mlstm_init, t_xl.mlstm_init),
                           (j_xl.slstm_init, t_xl.slstm_init)):
        pj = init_j(jax.random.PRNGKey(0), cfg_j, getattr(jnp, dtype))
        pt = init_t(gen, cfg_t, getattr(torch, dtype))
        assert _shapes(pt) == _shapes(pj)
        assert pt["f_bias"].dtype == torch.float32
        assert bool((pt["f_bias"] == 3.0).all())
    # the per-head projections are drawn apart, and at 1/sqrt(hd)
    p = t_xl.mlstm_init(torch.Generator().manual_seed(1), cfg_t)
    assert not torch.equal(p["wq"], p["wk"])
    assert not torch.equal(p["wq"][0], p["wq"][1])
    assert p["up"]["w"].shape == (cfg_t.d_model, 2 * cfg_t.d_inner_m)


def test_slstm_ffn_width_and_flops_equal_jax():
    for d, nh in ((16, 2), (40, 4), (128, 4), (2048, 4)):
        cj, ct = j_xl.XLSTMCfg(d_model=d, n_heads=nh), \
            t_xl.XLSTMCfg(d_model=d, n_heads=nh)
        assert t_xl._slstm_ffn_width(ct) == j_xl._slstm_ffn_width(cj)
        assert t_xl._slstm_ffn_width(ct) % 64 == 0
        for tokens, seq in ((1, 1), (128, 128), (1024, 256)):
            assert t_xl.mlstm_flops(tokens, seq, ct) == \
                j_xl.mlstm_flops(tokens, seq, cj)
            assert t_xl.slstm_flops(tokens, ct) == j_xl.slstm_flops(tokens, cj)
    assert (ct.d_inner_m, ct.head_dim_m, ct.head_dim_s) == (4096, 1024, 512)
    assert t_xl._slstm_ffn_width(ct) == 2752


# ------------------------------------------------------------------ mLSTM --
@pytest.mark.parametrize("name", sorted(CFGS))
def test_mlstm_block_and_prefill_match_jax(name):
    cfg_j, cfg_t = _cfgs(name)
    pj, pt = _weights(j_xl.mlstm_init, cfg_j, 3)
    xj, xt = _x(cfg_j, seed=4)
    _close(t_xl.mlstm_block(pt, xt, cfg_t), j_xl.mlstm_block(pj, xj, cfg_j))
    yj, sj = j_xl.mlstm_prefill(pj, xj, cfg_j)
    yt, st = t_xl.mlstm_prefill(pt, xt, cfg_t)
    _close(yt, yj)
    assert st.m.dtype == torch.float32
    _assert_trees_close(st._asdict(), sj._asdict(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_mlstm_decode_steps_match_jax(name):
    """From an empty state and from a prefill's, four steps each: outputs
    and every state leaf."""
    cfg_j, cfg_t = _cfgs(name)
    pj, pt = _weights(j_xl.mlstm_init, cfg_j, 5)
    xj, xt = _x(cfg_j, seed=6)
    _, sj0 = j_xl.mlstm_prefill(pj, xj[:, :5], cfg_j)
    _, st0 = t_xl.mlstm_prefill(pt, xt[:, :5], cfg_t)
    starts = [(j_xl.mlstm_state_init(cfg_j, 2),
               t_xl.mlstm_state_init(cfg_t, 2, device=CPU)), (sj0, st0)]
    _assert_trees_close(starts[0][1]._asdict(), starts[0][0]._asdict(),
                        rtol=0, atol=0)
    for sj, st in starts:
        for t in range(5, 9):
            before = to_numpy_tree(st._asdict())
            yj, sj = j_xl.mlstm_decode_step(pj, xj[:, t], sj, cfg_j)
            yt, st2 = t_xl.mlstm_decode_step(pt, xt[:, t], st, cfg_t)
            _assert_trees_close(st._asdict(), before, rtol=0, atol=0)
            st = st2
            _close(yt, yj)
            _assert_trees_close(st._asdict(), sj._asdict(), rtol=RTOL,
                                atol=ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_mlstm_parallel_vs_recurrent(name):
    """The port's own: prefill equals the block over its prefix, and the
    decode recurrence continues it (``TestXLSTM`` in the JAX package)."""
    _, cfg = _cfgs(name)
    p = t_xl.mlstm_init(torch.Generator().manual_seed(3), cfg)
    _, x = _x(cfg, seed=7)
    y_par = t_xl.mlstm_block(p, x, cfg)
    y_pre, st = t_xl.mlstm_prefill(p, x[:, :6], cfg)
    _close(y_pre, y_par[:, :6], rtol=0, atol=1e-5)
    for t in range(6, 10):
        y_t, st = t_xl.mlstm_decode_step(p, x[:, t], st, cfg)
        _close(y_t, y_par[:, t], rtol=0, atol=REF_ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_mlstm_block_grads_match_jax(name):
    cfg_j, cfg_t = _cfgs(name)
    pj, pt = _weights(j_xl.mlstm_init, cfg_j, 8)
    xj, xt = _x(cfg_j, seed=9)
    gj = jax.grad(lambda p, x: jnp.mean(j_xl.mlstm_block(p, x, cfg_j) ** 2),
                  argnums=(0, 1))(pj, xj)
    leaves = jax.tree_util.tree_map(lambda a: a.requires_grad_(True), pt)
    xg = xt.clone().requires_grad_(True)
    loss = torch.mean(t_xl.mlstm_block(leaves, xg, cfg_t) ** 2)
    loss.backward()
    _close(xg.grad, gj[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _assert_trees_close(jax.tree_util.tree_map(lambda a: a.grad, leaves),
                        gj[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------------------------------------------ sLSTM --
@pytest.mark.parametrize("name", sorted(CFGS))
def test_slstm_seq_and_ffn_match_jax(name):
    """The scan from an empty state and continued from its own final state,
    and the block's FFN."""
    cfg_j, cfg_t = _cfgs(name)
    pj, pt = _weights(j_xl.slstm_init, cfg_j, 10)
    xj, xt = _x(cfg_j, seed=11)
    hj, sj = j_xl.slstm_seq(pj, xj[:, :6], cfg_j)
    ht, st = t_xl.slstm_seq(pt, xt[:, :6], cfg_t)
    _close(ht, hj)
    assert st.m.dtype == torch.float32
    _assert_trees_close(st._asdict(), sj._asdict(), rtol=RTOL, atol=ATOL)
    hj, sj = j_xl.slstm_seq(pj, xj[:, 6:], cfg_j, sj)
    ht, st = t_xl.slstm_seq(pt, xt[:, 6:], cfg_t, st)
    _close(ht, hj)
    _assert_trees_close(st._asdict(), sj._asdict(), rtol=RTOL, atol=ATOL)
    _close(t_xl.slstm_block_ffn(pt, ht), j_xl.slstm_block_ffn(pj, hj))
    _close(t_xl.slstm_block(pt, xt, cfg_t), j_xl.slstm_block(pj, xj, cfg_j))
    assert t_xl.slstm_state_init(cfg_t, 2, device=CPU).h.shape == \
        (2, cfg_t.n_heads, cfg_t.head_dim_s)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_slstm_decode_steps_match_jax(name):
    cfg_j, cfg_t = _cfgs(name)
    pj, pt = _weights(j_xl.slstm_init, cfg_j, 12)
    xj, xt = _x(cfg_j, seed=13)
    sj = j_xl.slstm_state_init(cfg_j, 2)
    st = t_xl.slstm_state_init(cfg_t, 2, device=CPU)
    _assert_trees_close(st._asdict(), sj._asdict(), rtol=0, atol=0)
    for t in range(6):
        yj, sj = j_xl.slstm_decode_step(pj, xj[:, t], sj, cfg_j)
        yt, st = t_xl.slstm_decode_step(pt, xt[:, t], st, cfg_t)
        _close(yt, yj)
        _assert_trees_close(st._asdict(), sj._asdict(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_slstm_scan_vs_stepping(name):
    """The port's own: the block's scan equals stepping the decode cell
    (``TestXLSTM`` in the JAX package), and the packed recurrent weights
    give the cell what the per-gate products give."""
    _, cfg = _cfgs(name)
    p = t_xl.slstm_init(torch.Generator().manual_seed(5), cfg)
    _, x = _x(cfg, seed=14)
    y_blk = t_xl.slstm_block(p, x, cfg)
    st = t_xl.slstm_state_init(cfg, 2, device=CPU)
    outs = []
    for t in range(x.shape[1]):
        o, st = t_xl.slstm_decode_step(p, x[:, t], st, cfg)
        outs.append(o)
    _close(torch.stack(outs, 1), y_blk, rtol=0, atol=1e-5)
    h = torch.randn(2, cfg.n_heads, cfg.head_dim_s,
                    generator=torch.Generator().manual_seed(6))
    packed = torch.bmm(h.transpose(0, 1), t_xl._recurrent_weights(p["r"]))
    per_gate = torch.einsum("bhd,ghde->bghe", h, p["r"])
    _close(packed.reshape(cfg.n_heads, 2, 4, cfg.head_dim_s)
           .permute(1, 2, 0, 3), per_gate, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_slstm_block_grads_match_jax(name):
    """Through the Python loop of the scan (``lax.scan`` in JAX), the
    stabilizer's max and the ``max(|n|, 1)`` tie of the first step."""
    cfg_j, cfg_t = _cfgs(name)
    pj, pt = _weights(j_xl.slstm_init, cfg_j, 15)
    xj, xt = _x(cfg_j, S=8, seed=16)
    gj = jax.grad(lambda p, x: jnp.mean(j_xl.slstm_block(p, x, cfg_j) ** 2),
                  argnums=(0, 1))(pj, xj)
    leaves = jax.tree_util.tree_map(lambda a: a.requires_grad_(True), pt)
    xg = xt.clone().requires_grad_(True)
    torch.mean(t_xl.slstm_block(leaves, xg, cfg_t) ** 2).backward()
    _close(xg.grad, gj[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _assert_trees_close(jax.tree_util.tree_map(lambda a: a.grad, leaves),
                        gj[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
