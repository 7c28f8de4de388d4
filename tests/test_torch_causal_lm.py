"""The port's monolithic causal LM (dense and vlm families; every ported
config's ``count_params``) and the convnet OP-DAG against the JAX
package, on the same weights, on the CPU.

Weights are made by the JAX package and carried across with
``from_numpy_tree``.  Logits and losses are held at rtol 1e-5, atol 1e-6,
gradients at rtol 1e-4 (atol 1e-6 for entries near zero): the frameworks
sum in other orders.  ``count_params`` is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ModelCfg as JModelCfg  # noqa: E402
from repro.configs import resolve as j_resolve  # noqa: E402
from repro.core.rad import single_device_loss_and_grad as j_sdlg  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro.models import encdec as j_ed  # noqa: E402
from repro.models.opgraph_models import convnet_opgraph as j_convnet  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core.opgraph import tree_leaves  # noqa: E402
from repro_torch.core.rad import single_device_loss_and_grad as t_sdlg  # noqa: E402
from repro_torch.distributed.steps import loss_and_grad  # noqa: E402
from repro_torch.models import causal_lm as t_lm  # noqa: E402
from repro_torch.models import encdec as t_ed  # noqa: E402
from repro_torch.models import scan_config  # noqa: E402
from repro_torch.models.opgraph_models import convnet_opgraph as t_convnet  # noqa: E402
from test_torch_models import ATOL, CPU, RTOL, _assert_trees_close, _np_tree  # noqa: E402

ARCHS = ["gpt2-xl", "llama3-8b", "mistral-nemo-12b", "stablelm-12b",
         "granite-3-8b", "internvl2-2b"]
GRAD_RTOL = 1e-4


def _cfgs(arch, size="smoke"):
    return (getattr(j_resolve(arch), size), getattr(t_resolve(arch), size))


def _padded(cfg):
    """gpt2-smoke with a vocabulary padded past its true size, so the head
    masks padding classes (the full gpt2-xl pads 50257 to 50432)."""
    return cfg.replace(vocab=500, vocab_pad_to=256)


def lm_setup(arch, batch=2, seq=16, seed=0, pad=False):
    cfg_j, cfg_t = _cfgs(arch)
    if pad:
        cfg_j, cfg_t = _padded(cfg_j), _padded(cfg_t)
    pj = j_lm.init(cfg_j, jax.random.PRNGKey(seed))
    pt = from_numpy_tree(_np_tree(pj), CPU)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_j.vocab, size=(batch, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg_j.n_prefix:
        b["prefix_embeds"] = rng.standard_normal(
            (batch, cfg_j.n_prefix, cfg_j.d_frontend)).astype(np.float32)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=pt, bj=bj, bt=bt)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


# ------------------------------------------------------------------ init --
@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_jax_key_paths_shapes_and_count(arch):
    cfg_j, cfg_t = _cfgs(arch)
    pj = j_lm.init(cfg_j, jax.random.PRNGKey(0))
    pt = t_lm.init(cfg_t, torch.Generator().manual_seed(0))
    assert _shapes(to_numpy_tree(pt)) == _shapes(_np_tree(pj))
    assert all(t.dtype == torch.float32 for t in tree_leaves(pt))
    assert sum(t.numel() for t in tree_leaves(pt)) == t_lm.count_params(cfg_t)
    # the stacked blocks are drawn layer by layer: no two layers alike
    wq = pt["blocks"]["attn"]["wq"]["w"]
    assert not torch.equal(wq[0], wq[1])


def test_init_is_reproducible_from_its_generator():
    cfg = t_resolve("llama3-8b").smoke
    a = t_lm.init(cfg, torch.Generator().manual_seed(3))
    b = t_lm.init(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS + ["zamba2-7b", "deepseek-moe-16b",
                                          "mixtral-8x7b"])
def test_count_params_equals_jax(arch, size):
    cfg_j, cfg_t = _cfgs(arch, size)
    assert t_lm.count_params(cfg_t) == j_lm.count_params(cfg_j)


def test_count_params_moe_arithmetic_and_unported_families():
    kw = dict(name="moe-t", family="moe", n_layers=3, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=96, vocab=300, vocab_pad_to=64, n_experts=4,
              top_k=2, n_shared_experts=1, qkv_bias=True)
    assert t_lm.count_params(TModelCfg(**kw)) == \
        j_lm.count_params(JModelCfg(**kw))
    # the moe block is ported (ROADMAP Q1.2): its count is what init draws
    moe = t_lm.init(TModelCfg(**kw), torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(moe)) == \
        t_lm.count_params(TModelCfg(**kw))
    # the xLSTM family is ported (ROADMAP Q1.3b): its count is JAX's and
    # what init draws
    xl = dict(name="xl", family="xlstm", n_layers=5, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=0, vocab=64, slstm_every=2)
    assert [tuple(s) for s in t_lm.segments(TModelCfg(**xl))] == \
        [tuple(s) for s in j_lm.segments(JModelCfg(**xl))]
    drawn = t_lm.init(TModelCfg(**xl), torch.Generator().manual_seed(0))
    assert t_lm.count_params(TModelCfg(**xl)) == \
        j_lm.count_params(JModelCfg(**xl)) == \
        sum(t.numel() for t in tree_leaves(drawn))
    # the encoder-decoder is ported (ROADMAP Q1.3c) as its own module, as
    # in JAX: its count is JAX's and what encdec.init draws, and causal_lm
    # refuses it with JAX's error
    ed = dict(name="ed", family="encdec", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, n_enc_layers=2,
              d_frontend=32)
    drawn = t_ed.init(TModelCfg(**ed), torch.Generator().manual_seed(0))
    assert t_ed.count_params(TModelCfg(**ed)) == \
        j_ed.count_params(JModelCfg(**ed)) == \
        sum(t.numel() for t in tree_leaves(drawn))
    for t_fn, j_fn in (
            (t_lm.segments, j_lm.segments),
            (t_lm.count_params, j_lm.count_params),
            (lambda c: t_lm.init(c, torch.Generator().manual_seed(0)),
             lambda c: j_lm.init(c, jax.random.PRNGKey(0)))):
        with pytest.raises(ValueError, match="unknown family 'encdec'"):
            j_fn(JModelCfg(**ed))
        with pytest.raises(ValueError, match="unknown family 'encdec'"):
            t_fn(TModelCfg(**ed))


# --------------------------------------------------------------- forward --
@pytest.mark.parametrize("arch,pad", [(a, False) for a in ARCHS]
                         + [("gpt2-xl", True)])
def test_forward_and_train_loss_match_jax(arch, pad):
    s = lm_setup(arch, pad=pad)
    lj, aj = j_lm.forward(s["cfg_j"], s["pj"], s["bj"]["tokens"],
                          s["bj"].get("prefix_embeds"))
    lt, at = t_lm.forward(s["cfg_t"], s["pt"], s["bt"]["tokens"],
                          s["bt"].get("prefix_embeds"))
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    assert float(at) == float(aj) == 0.0
    if pad:
        assert bool((lt[..., s["cfg_t"].vocab:] == -1e30).all())
    (Lj, mj) = j_lm.train_loss(s["cfg_j"], s["pj"], s["bj"])
    (Lt, mt) = t_lm.train_loss(s["cfg_t"], s["pt"], s["bt"])
    assert set(mt) == set(mj) == {"ce", "aux"}
    for a, b in ((Lt, Lj), (mt["ce"], mj["ce"]), (mt["aux"], mj["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=ATOL)


def test_vlm_needs_its_prefix():
    s = lm_setup("internvl2-2b")
    with pytest.raises(ValueError, match="prefix_embeds"):
        t_lm.forward(s["cfg_t"], s["pt"], s["bt"]["tokens"])


@pytest.mark.parametrize("arch", ["gpt2-xl", "llama3-8b", "mistral-nemo-12b",
                                  "stablelm-12b", "granite-3-8b",
                                  "internvl2-2b", "deepseek-moe-16b"])
def test_train_loss_grads_match_jax(arch):
    s = lm_setup(arch)
    (lj, _), gj = jax.value_and_grad(
        lambda p: j_lm.train_loss(s["cfg_j"], p, s["bj"]), has_aux=True)(
            s["pj"])
    lt, _, gt = loss_and_grad(s["cfg_t"], s["pt"], s["bt"])
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    _assert_trees_close(gt, gj, rtol=GRAD_RTOL, atol=ATOL)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["gpt2-xl", "llama3-8b"])
def test_remat_gives_the_same_grads(arch, policy):
    s = lm_setup(arch)
    l0, _, g0 = loss_and_grad(s["cfg_t"], s["pt"], s["bt"])
    cfg = s["cfg_t"].replace(remat=True, remat_policy=policy)
    l1, _, g1 = loss_and_grad(cfg, s["pt"], s["bt"])
    assert float(l1) == float(l0)
    _assert_trees_close(g1, g0, rtol=1e-6, atol=1e-6)


def test_dots_policy_saves_plain_matmuls_only():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    assert t_lm._save_dots(None, aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert t_lm._save_dots(None, aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.gelu.default, aten.add.Tensor):
        assert t_lm._save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


# ------------------------------------------------------------------ scan --
def test_scan_unbinds_each_stacked_leaf_once():
    """Layers come from one ``unbind`` per leaf; no ``select`` (``a[i]``)
    reaches the backward graph, whose backward would build a zero tensor
    the size of the whole stack for every layer."""
    stacked = {"w": torch.randn(5, 3, 3, requires_grad=True),
               "b": {"v": torch.randn(5, 3, requires_grad=True)}}

    def body(h, pl):
        h = h @ pl["w"] + pl["b"]["v"]
        return h, h.sum()

    out, ys = scan_config.scan(body, torch.ones(2, 3), stacked)
    assert len(ys) == 5
    names = set()
    todo = [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or type(fn).__name__ in names:
            continue
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    assert "UnbindBackward0" in names
    assert not any(n.startswith("SelectBackward") for n in names)
    want = torch.ones(2, 3)
    for i in range(5):
        want = want @ stacked["w"][i] + stacked["b"]["v"][i]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert scan_config.scan(lambda h, pl: (h, None), out, stacked)[1] is None
    with scan_config.set_unroll(True):
        again, _ = scan_config.scan(body, torch.ones(2, 3), stacked)
    assert torch.equal(again, out)


def test_pick_takes_one_layer_of_the_stack():
    s = lm_setup("llama3-8b")
    got = to_numpy_tree(t_lm._pick(s["pt"]["blocks"], 1))
    want = _np_tree(jax.tree_util.tree_map(lambda a: a[1],
                                           s["pj"]["blocks"]))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- convnet --
@pytest.mark.parametrize("hw", [16, 15])
def test_convnet_forward_and_grads_match_jax(hw):
    """At hw 16 XLA's SAME pads each spatial axis (0, 1) for the stride-2
    3x3 conv; at 15, (1, 1).  ``padding=1`` would match only the second."""
    gj, gt = j_convnet(hw=hw), t_convnet(hw=hw)
    shapes = {"images": (4, hw, hw, 3), "labels": (4,)}
    prof = lambda g: {n: (p.out_shape, p.fwd_flops, p.out_bytes,  # noqa: E731
                          p.n_params) for n, p in g.annotate(shapes).items()}
    assert prof(gt) == prof(gj)
    pj = gj.init(jax.random.PRNGKey(0), shapes)
    pt = from_numpy_tree(_np_tree(pj), CPU)
    assert _shapes(to_numpy_tree(gt.init(torch.Generator().manual_seed(0),
                                         shapes))) == _shapes(_np_tree(pj))
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((4, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    ij = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    it = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    vj, vt = gj.apply(pj, ij), gt.apply(pt, it)
    for name in ("conv_0", "conv_1", "conv_2", "fc"):
        np.testing.assert_allclose(vt[name].numpy(), np.asarray(vj[name]),
                                   rtol=RTOL, atol=ATOL)
    lj, grj = j_sdlg(gj, pj, ij)
    lt, grt = t_sdlg(gt, pt, it)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    _assert_trees_close(grt, grj, rtol=GRAD_RTOL, atol=ATOL)
