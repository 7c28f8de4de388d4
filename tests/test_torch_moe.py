"""The port's MoE layers against the JAX package, on the same weights and
inputs, on the CPU.

``route``'s expert choices are equal; the three paths (``moe_loop``,
``moe_ragged``, ``moe_capacity``) hold JAX's outputs and each other's at
rtol 1e-5, atol 1e-6 (the frameworks sum in other orders), and the
auxiliary loss too.  The combine sums a token's choices in rank order on
every device, so repeated calls are bit-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as j_moe  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from test_torch_models import ATOL, CPU, RTOL, _np_tree  # noqa: E402

D, DFF, E = 32, 48, 6


def _setup(top_k, n_shared=0, T=(2, 9), seed=0):
    pj = j_moe.moe_init(jax.random.PRNGKey(seed), D, DFF, E, n_shared)
    pt = from_numpy_tree(_np_tree(pj), CPU)
    x = np.random.default_rng(seed).standard_normal(T + (D,)).astype(
        np.float32)
    return pj, pt, jnp.asarray(x), torch.from_numpy(x)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_init_has_jax_key_paths_and_shapes(n_shared):
    pj = j_moe.moe_init(jax.random.PRNGKey(0), D, DFF, E, n_shared)
    pt = t_moe.moe_init(torch.Generator().manual_seed(0), D, DFF, E,
                        n_shared)
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
    assert shapes(to_numpy_tree(pt)) == shapes(_np_tree(pj))
    # the JAX weights cross whole: router, gate, up, down, shared
    back = to_numpy_tree(from_numpy_tree(_np_tree(pj), CPU))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np_tree(pj))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np_tree(pj))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_matches_jax(top_k):
    pj, pt, xj, xt = _setup(top_k)
    gj, ij, aj = j_moe.route(pj["router"], xj.reshape(-1, D), top_k)
    gt, it, at = t_moe.route(pt["router"], xt.reshape(-1, D), top_k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(gt, gj)
    _close(at, aj)


@pytest.mark.parametrize("impl", ["loop", "ragged", "capacity"])
@pytest.mark.parametrize("top_k,n_shared", [(1, 0), (2, 0), (3, 1), (2, 1)])
def test_moe_paths_match_jax(impl, top_k, n_shared):
    pj, pt, xj, xt = _setup(top_k, n_shared)
    # capacity large enough that no token is dropped: all paths agree
    kw = {"capacity_factor": float(E)} if impl == "capacity" else {}
    yj, aj = j_moe.moe_apply(pj, xj, top_k, impl, **kw)
    yt, at = t_moe.moe_apply(pt, xt, top_k, impl, **kw)
    assert yt.shape == tuple(yj.shape)
    _close(yt, yj)
    _close(at, aj)
    loop = t_moe.moe_loop(pt, xt, top_k).y
    _close(yt, loop)


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_capacity_drops_match_jax(capacity):
    """Tokens past an expert's capacity lose their gate mass, as in JAX."""
    pj, pt, xj, xt = _setup(2, T=(3, 8), seed=4)
    yj, _ = j_moe.moe_capacity(pj, xj, 2, capacity=capacity)
    yt, _ = t_moe.moe_capacity(pt, xt, 2, capacity=capacity)
    _close(yt, yj)
    full = t_moe.moe_ragged(pt, xt, 2).y
    assert not torch.allclose(yt, full)


def test_combine_is_rank_ordered_and_repeatable():
    """top_k = 4: each token's output is the sum of its four weighted
    expert outputs taken in rank order, bit for bit, call after call."""
    pj, pt, xj, xt = _setup(4, T=(1, 7), seed=2)
    y = t_moe.moe_ragged(pt, xt, 4).y
    assert torch.equal(y, t_moe.moe_ragged(pt, xt, 4).y)
    x2 = xt.reshape(-1, D)
    gates, idx, _ = t_moe.route(pt["router"], x2, 4)
    want = None
    for k in range(4):
        out = torch.stack([t_moe._expert_ffn(
            x2[t:t + 1], pt["gate"][e], pt["up"][e], pt["down"][e])[0]
            for t, e in enumerate(idx[:, k].tolist())])
        term = out * gates[:, k:k + 1]
        want = term if want is None else want + term
    torch.testing.assert_close(y.reshape(-1, D), want, rtol=RTOL, atol=ATOL)


def test_unknown_impl_raises():
    _, pt, _, xt = _setup(2)
    with pytest.raises(ValueError, match="unknown moe impl"):
        t_moe.moe_apply(pt, xt, 2, "dense")


def test_moe_flops_match_jax():
    assert t_moe.moe_flops(64, D, DFF, 2, 3 * DFF) == \
        j_moe.moe_flops(64, D, DFF, 2, 3 * DFF)
