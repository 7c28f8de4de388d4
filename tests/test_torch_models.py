"""The port's model code against the JAX package's on the same weights.

Weights are made by the JAX package, carried across with
``from_numpy_tree``, and both sides compute in fp32 on the CPU.  The
tolerance (rtol 1e-5, atol 1e-6) covers the two frameworks' different
summation orders in matmuls and reductions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import resolve as j_resolve  # noqa: E402
from repro.core.rad import single_device_loss_and_grad as j_sdlg  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.opgraph_models import gpt_opgraph as j_gpt  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core.opgraph import tree_leaves  # noqa: E402
from repro_torch.core.rad import single_device_loss_and_grad as t_sdlg  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.opgraph_models import gpt_opgraph as t_gpt  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(t_tree, j_tree, rtol=RTOL, atol=ATOL):
    """Leaves compared by key path; ``j_tree`` may be JAX's or the port's."""
    t_np = to_numpy_tree(t_tree)
    j_np = (to_numpy_tree(j_tree) if isinstance(
        next(iter(tree_leaves(j_tree))), torch.Tensor) else _np_tree(j_tree))
    assert jax.tree_util.tree_structure(t_np) == \
        jax.tree_util.tree_structure(j_np)
    for a, b in zip(jax.tree_util.tree_leaves(t_np),
                    jax.tree_util.tree_leaves(j_np)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def smoke_setup(batch=2, seq=16, seed=0):
    """gpt2-xl's smoke config through both packages, JAX weights in both."""
    cfg_j = j_resolve("gpt2-xl").smoke
    cfg_t = t_resolve("gpt2-xl").smoke
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    gj, gt = j_gpt(cfg_j, batch, seq), t_gpt(cfg_t, batch, seq)
    pj = gj.init(jax.random.PRNGKey(seed), shapes)
    pt = from_numpy_tree(_np_tree(pj), CPU)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_j.vocab, size=(batch, seq + 1)).astype(np.int32)
    batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    ij = {k: jnp.asarray(v) for k, v in batch_np.items()}
    it = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    return dict(cfg=cfg_t, shapes=shapes, gj=gj, gt=gt, pj=pj, pt=pt,
                ij=ij, it=it, batch_np=batch_np)


def test_gpt_opgraph_loss_and_grads_match_jax():
    s = smoke_setup()
    lj, grj = j_sdlg(s["gj"], s["pj"], s["ij"])
    lt, grt = t_sdlg(s["gt"], s["pt"], s["it"])
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    _assert_trees_close(grt, grj)


def test_graph_init_has_the_jax_key_paths_and_shapes():
    s = smoke_setup()
    gen = torch.Generator().manual_seed(0)
    pt = s["gt"].init(gen, s["shapes"])
    shapes_t = jax.tree_util.tree_map(lambda a: a.shape, to_numpy_tree(pt))
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, _np_tree(s["pj"]))
    assert shapes_t == shapes_j
    assert all(t.dtype == torch.float32 for t in tree_leaves(pt))
    again = s["gt"].init(torch.Generator().manual_seed(0), s["shapes"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pt),
                                                  tree_leaves(again)))


@pytest.mark.parametrize("n_heads,n_kv,rope", [(4, 4, 0.0), (4, 2, 1.0),
                                               (6, 2, 0.5)])
def test_attention_matches_jax(n_heads, n_kv, rope):
    rng = np.random.default_rng(n_heads + n_kv)
    d, hd, B, S = 48, 8, 2, 10
    pj = j_attn.attn_init(jax.random.PRNGKey(1), d, n_heads, n_kv, hd)
    pt = from_numpy_tree(_np_tree(pj), CPU)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    for window in (None, 3):
        kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd, window=window,
                  rope_fraction=rope)
        yj = j_attn.attn_train(pj, jnp.asarray(x), **kw)
        yt = t_attn.attn_train(pt, torch.from_numpy(x), **kw)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_layers_match_jax(act):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for kind in ("layernorm", "rmsnorm"):
        pj = jax.tree_util.tree_map(
            lambda a: a * 1.5 + 0.25, j_layers.norm_init(kind, 32))
        pt = from_numpy_tree(_np_tree(pj), CPU)
        np.testing.assert_allclose(
            t_layers.norm_apply(kind, pt, xt).numpy(),
            np.asarray(j_layers.norm_apply(kind, pj, xj)), rtol=RTOL,
            atol=ATOL)
    pj = j_layers.mlp_init(jax.random.PRNGKey(2), 32, 64, act)
    pt = from_numpy_tree(_np_tree(pj), CPU)
    np.testing.assert_allclose(t_layers.mlp(pt, xt, act).numpy(),
                               np.asarray(j_layers.mlp(pj, xj, act)),
                               rtol=RTOL, atol=ATOL)
    logits = rng.standard_normal((4, 6, 50)).astype(np.float32) * 4
    labels = rng.integers(-1, 50, size=(4, 6)).astype(np.int32)
    np.testing.assert_allclose(
        float(t_layers.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels))),
        float(j_layers.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels))),
        rtol=RTOL, atol=ATOL)


def test_weights_round_trip_bit_exact():
    s = smoke_setup()
    back = to_numpy_tree(s["pt"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np_tree(s["pj"]))):
        np.testing.assert_array_equal(a, b)
    bf = from_numpy_tree({"w": np.asarray(jnp.arange(4, dtype=jnp.bfloat16))},
                         CPU)
    assert bf["w"].dtype == torch.bfloat16
    assert bf["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
