"""The port's Mamba2 (SSD) blocks and causal conv against the JAX package,
on the same inputs and weights, on the CPU.  The hybrid family built from
them is held in ``tests/test_torch_hybrid.py``.

Inputs are drawn with numpy from a seed; weights are made by the JAX
package and carried across with ``from_numpy_tree``.  Tolerances:
- outputs and states at rtol 1e-5, atol 1e-5 (the frameworks sum in
  other orders, and the chunked SSD sums a cumulative decay);
- the chunked SSD against the literal recurrence, and a decode step
  against the full-sequence block, at atol 1e-4, as in the JAX package's
  own test (a sum in another order over up to 32 steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as j_layers  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from test_torch_models import CPU, _np_tree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
REF_ATOL = 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _both(a):
    """A numpy array as (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ conv --
@pytest.mark.parametrize("width,S", [(4, 9), (2, 5), (4, 2)])
def test_causal_conv1d_and_step_match_jax(width, S):
    rng = np.random.default_rng(width * 10 + S)
    C, B = 6, 2
    pj = j_layers.causal_conv1d_init(jax.random.PRNGKey(1), C, width)
    pj = {"w": pj["w"], "b": jnp.asarray(rng.standard_normal(C),
                                         jnp.float32)}
    pt = from_numpy_tree(_np_tree(pj), CPU)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    xj, xt = _both(x)
    _close(t_layers.causal_conv1d(pt, xt), j_layers.causal_conv1d(pj, xj))
    win = rng.standard_normal((B, width - 1, C)).astype(np.float32)
    wj, wt = _both(win)
    for t in range(S):
        yj, wj = j_layers.causal_conv1d_step(pj, xj[:, t], wj)
        yt, wt = t_layers.causal_conv1d_step(pt, xt[:, t], wt)
        _close(yt, yj)
        _close(wt, wj, rtol=0, atol=0)
    # stepping from an empty window equals the full-sequence conv
    wt = torch.zeros(B, width - 1, C)
    full = t_layers.causal_conv1d(pt, xt)
    for t in range(S):
        yt, wt = t_layers.causal_conv1d_step(pt, xt[:, t], wt)
        _close(yt, full[:, t])


def test_causal_conv1d_init_draws_in_range():
    p = t_layers.causal_conv1d_init(torch.Generator().manual_seed(0), 300, 4)
    assert p["w"].shape == (4, 300) and p["b"].shape == (300,)
    assert float(p["w"].abs().max()) <= 0.5 and not bool(p["b"].any())
    assert float(p["w"].std()) > 0.2    # uniform on [-0.5, 0.5]: 0.29


def test_norm_inits_take_the_callers_device():
    for fn in (t_layers.rmsnorm_init, t_layers.layernorm_init):
        with pytest.raises(TypeError):
            fn(8)
        assert fn(8, device=CPU)["scale"].device == CPU
    with pytest.raises(TypeError):
        t_layers.norm_init("rmsnorm", 8)


# ------------------------------------------------------------------- SSD --
def _ssd_inputs(B=2, S=32, nh=3, hd=8, ds=5, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, dt_raw, A_raw = f(B, S, nh, hd), f(B, S, nh), f(nh)
    dt = np.array(jax.nn.softplus(jnp.asarray(dt_raw)))
    A = -np.exp(A_raw).astype(np.float32)
    return x, dt, A, f(B, S, ds), f(B, S, ds), f(nh)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_jax_and_reference(chunk):
    args = _ssd_inputs()
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    yj, hj = j_ssm.ssd_chunked(*jargs, chunk=chunk)
    yt, ht = t_ssm.ssd_chunked(*targs, chunk=chunk)
    assert yt.shape == (2, 32, 3, 8) and ht.shape == (2, 3, 5, 8)
    assert ht.dtype == torch.float32
    _close(yt, yj)
    _close(ht, hj)
    ref_t = t_ssm.ssd_reference(*targs)
    _close(ref_t, j_ssm.ssd_reference(*jargs))
    _close(yt, ref_t, rtol=0, atol=REF_ATOL)


def test_ssd_chunk_must_divide():
    args = [torch.from_numpy(a) for a in _ssd_inputs(S=30)]
    with pytest.raises(ValueError, match="not divisible by chunk 8"):
        t_ssm.ssd_chunked(*args, chunk=8)
    with pytest.raises(ValueError, match="not divisible by chunk 8"):
        j_ssm.ssd_chunked(*[jnp.asarray(a.numpy()) for a in args], chunk=8)


def test_ssd_state_continuation_with_h0():
    """ssd(suffix, h0=state after the prefix) == the suffix of ssd(full),
    and equals JAX's continuation."""
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in _ssd_inputs())
    y_full, h_full = t_ssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=8)
    _, h_pre = t_ssm.ssd_chunked(x[:, :16], dt[:, :16], A, Bm[:, :16],
                                 Cm[:, :16], D, chunk=8)
    y_suf, h_end = t_ssm.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bm[:, 16:],
                                     Cm[:, 16:], D, chunk=8, h0=h_pre)
    _close(y_suf, y_full[:, 16:], rtol=0, atol=REF_ATOL)
    _close(h_end, h_full, rtol=0, atol=REF_ATOL)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    yj, hj = j_ssm.ssd_chunked(j(x[:, 16:]), j(dt[:, 16:]), j(A),
                               j(Bm[:, 16:]), j(Cm[:, 16:]), j(D), chunk=8,
                               h0=j(h_pre))
    _close(y_suf, yj)
    _close(h_end, hj)


def test_softplus_is_jaxs_at_every_magnitude():
    x = np.concatenate([np.linspace(-60, 60, 241, dtype=np.float32),
                        np.float32([19.9, 20.0, 20.1, 25.0, 1e-3])])
    got = t_ssm.softplus(torch.from_numpy(x)).numpy()
    _close(got, jax.nn.softplus(jnp.asarray(x)), rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- Mamba block --
MC = dict(d_model=16, d_inner=32, n_heads=4, head_dim=8, d_state=5, chunk=4)


def _mamba(seed=1):
    mj, mt = j_ssm.MambaCfg(**MC), t_ssm.MambaCfg(**MC)
    pj = j_ssm.mamba_init(jax.random.PRNGKey(seed), mj)
    # a non-zero conv bias and D, so both terms are held
    rng = np.random.default_rng(seed)
    pj["conv"]["b"] = jnp.asarray(rng.standard_normal(
        pj["conv"]["b"].shape), jnp.float32) * 0.1
    pj["D"] = jnp.asarray(rng.standard_normal(4), jnp.float32)
    return mj, mt, pj, from_numpy_tree(_np_tree(pj), CPU)


def test_mamba_init_has_jax_key_paths_and_shapes():
    mj, mt, pj, _ = _mamba()
    pt = t_ssm.mamba_init(torch.Generator().manual_seed(0), mt)
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
    assert shapes(to_numpy_tree(pt)) == shapes(_np_tree(pj))
    dt0 = t_ssm.softplus(pt["dt_bias"])      # softplus^-1 of dt in [1e-3, 0.1]
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt0.max()) <= 0.1 * (1 + 1e-5)
    _close(pt["A_log"], np.log(np.linspace(1.0, 16.0, 4)), rtol=1e-6,
           atol=0)
    _close(pt["A_log"], pj["A_log"], rtol=1e-6, atol=0)


def test_mamba_train_prefill_and_decode_match_jax():
    mj, mt, pj, pt = _mamba()
    x = np.random.default_rng(2).standard_normal((2, 12, 16)).astype(
        np.float32)
    xj, xt = _both(x)
    _close(t_ssm.mamba_train(pt, xt, mt), j_ssm.mamba_train(pj, xj, mj))
    yj, sj = j_ssm.mamba_prefill(pj, xj[:, :8], mj)
    yt, st = t_ssm.mamba_prefill(pt, xt[:, :8], mt)
    assert isinstance(st, t_ssm.MambaState)
    _close(yt, yj)
    _close(st.h, sj.h)
    _close(st.conv, sj.conv, rtol=0, atol=0)
    y_full = t_ssm.mamba_train(pt, xt, mt)
    for t in range(8, 12):
        before = (st.h.clone(), st.conv.clone())
        yj, sj = j_ssm.mamba_decode_step(pj, xj[:, t], sj, mj)
        yt, st2 = t_ssm.mamba_decode_step(pt, xt[:, t], st, mt)
        assert torch.equal(st.h, before[0]) and torch.equal(st.conv,
                                                              before[1])
        st = st2
        _close(yt, yj)
        _close(st.h, sj.h)
        _close(st.conv, sj.conv)
        _close(yt, y_full[:, t], rtol=0, atol=REF_ATOL)
    s0j = j_ssm.mamba_state_init(mj, 3)
    s0t = t_ssm.mamba_state_init(mt, 3, device=CPU)
    assert s0t.h.shape == s0j.h.shape and s0t.conv.shape == s0j.conv.shape
    assert not bool(s0t.h.any()) and not bool(s0t.conv.any())
    assert t_ssm.mamba_flops(12, mt) == j_ssm.mamba_flops(12, mj)
