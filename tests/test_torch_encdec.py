"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-large-v2)
against the JAX package, on the same weights, on the CPU: the config,
``init``, ``count_params``, ``encode``, ``train_loss`` and its gradients
(with and without remat), and the loader's frame embeddings.  Its serving
path and step builders are held in ``tests/test_torch_encdec_serve.py``,
with this file's configs and tolerances.

Two configs: seamless-smoke (one encoder and one decoder layer, no
padded vocabulary) and ``ed-pad``, two layers a side with a vocabulary
padded past its true size, so the stacks' axis 0 and the head's -1e30
mask are both exercised.

Weights are made by the JAX package and carried across with
``from_numpy_tree``.  Values (memory, logits, losses, cache leaves) are
held at rtol 1e-5, atol 1e-5, gradients and parameters after an update at
rtol 1e-4, atol 1e-6 (the frameworks sum in other orders); counts, key
paths, shapes and an empty cache are exact.  Decoding is teacher-forced on
JAX's greedy tokens, so a near-tie cannot send the two packages down
different sequences.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import resolve as j_resolve  # noqa: E402
from repro.data import SyntheticSeq2Seq as JSeq2Seq  # noqa: E402
from repro.models import encdec as j_ed  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core.opgraph import tree_leaves  # noqa: E402
from repro_torch.data import ShardedLoader, SyntheticSeq2Seq  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.models import encdec as t_ed  # noqa: E402
from test_torch_models import CPU, _assert_trees_close, _np_tree  # noqa: E402

ARCH = "seamless-m4t-large-v2"
RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
NAMES = ["seamless-smoke", "ed-pad"]
ED_PAD = dict(name="ed-pad", n_layers=4, n_enc_layers=2, vocab=500,
              vocab_pad_to=64)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _cfgs(name):
    j, t = j_resolve(ARCH).smoke, t_resolve(ARCH).smoke
    if name == "ed-pad":
        j, t = j.replace(**ED_PAD), t.replace(**ED_PAD)
    return j, t


@functools.lru_cache(maxsize=None)
def _ed(name):
    """(JAX cfg, port cfg, JAX weights, the same weights in the port); made
    once a name (no test writes into them)."""
    cfg_j, cfg_t = _cfgs(name)
    pj = j_ed.init(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, from_numpy_tree(_np_tree(pj), CPU)


def _batch(cfg, B=2, S_src=16, S=12, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S_src, cfg.d_frontend)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"src_embeds": src, "tokens": toks[:, :-1],
         "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    cfg_j, _, pj, _ = _ed(name)
    bj, _ = _batch(cfg_j, S=8, seed=1)
    (lj, _), gj = jax.value_and_grad(
        lambda p: j_ed.train_loss(cfg_j, p, bj), has_aux=True)(pj)
    return lj, gj


# ---------------------------------------------------------------- config --
def test_config_and_arch_ids_equal_jax():
    assert T_ARCH_IDS == J_ARCH_IDS
    ej, et = j_resolve(ARCH), t_resolve(ARCH)
    assert (et.shapes, et.skip_notes) == (ej.shapes, ej.skip_notes)
    assert "long_500k" not in et.shapes
    for cj, ct in ((ej.full, et.full), (ej.smoke, et.smoke)):
        fj, ft = dataclasses.asdict(cj), dataclasses.asdict(ct)
        for k in ("dtype", "param_dtype"):
            assert np.dtype(fj.pop(k)).name == str(ft.pop(k)).split(".")[-1]
        assert ft == fj
    full = et.full
    assert (full.n_enc_layers, full.n_dec_layers, full.vocab_padded) == \
        (12, 12, 256_256)
    assert t_ed.count_params(full) == j_ed.count_params(ej.full) == \
        1_079_635_968


@pytest.mark.parametrize("name", NAMES)
def test_init_key_paths_shapes_and_count(name):
    cfg_j, cfg_t, pj, _ = _ed(name)
    pt = t_ed.init(cfg_t, torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
    assert shapes(to_numpy_tree(pt)) == shapes(_np_tree(pj))
    n = sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(pj))
    assert t_ed.count_params(cfg_t) == j_ed.count_params(cfg_j) == n == \
        sum(t.numel() for t in tree_leaves(pt))
    # layers are drawn apart
    for side in ("enc", "dec"):
        w = pt[side]["mlp"]["up"]["w"]
        if w.shape[0] > 1:
            assert not torch.equal(w[0], w[1])
    # on the generator's device, as every init of the port
    assert all(t.device.type == "cpu" for t in tree_leaves(pt))


# --------------------------------------------------------------- training --
@pytest.mark.parametrize("name", NAMES)
def test_encode_and_train_loss_match_jax(name):
    cfg_j, cfg_t, pj, pt = _ed(name)
    bj, bt = _batch(cfg_j)
    _close(t_ed.encode(cfg_t, pt, bt["src_embeds"]),
           j_ed.encode(cfg_j, pj, bj["src_embeds"]))
    mem_j = j_ed.encode(cfg_j, pj, bj["src_embeds"])
    lj = j_ed._decoder_train(cfg_j, pj, bj["tokens"], mem_j)
    lt = t_ed._decoder_train(cfg_t, pt, bt["tokens"],
                             t_ed.encode(cfg_t, pt, bt["src_embeds"]))
    assert lt.shape == lj.shape == (2, 12, cfg_t.vocab_padded)
    _close(lt, lj)
    if cfg_t.vocab_padded != cfg_t.vocab:
        assert bool((lt[..., cfg_t.vocab:] == -1e30).all())
    (Lj, mj), (Lt, mt) = (j_ed.train_loss(cfg_j, pj, bj),
                          t_ed.train_loss(cfg_t, pt, bt))
    for a, b in ((Lt, Lj), (mt["ce"], mj["ce"])):
        _close(a, b)
    assert mt["aux"].dtype == torch.float32 and mt["aux"].dim() == 0
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0


@pytest.mark.parametrize("remat,policy", [(False, "nothing"),
                                          (True, "nothing"), (True, "dots")])
@pytest.mark.parametrize("name", NAMES)
def test_grads_match_jax(name, remat, policy):
    cfg_j, cfg_t, _, pt = _ed(name)
    cfg_t = cfg_t.replace(remat=remat, remat_policy=policy)
    _, bt = _batch(cfg_j, S=8, seed=1)
    lj, gj = _jax_grads(name)
    lt, mt, gt = t_steps.loss_and_grad(cfg_t, pt, bt)
    _close(lt, lj)
    assert set(mt) == {"ce", "aux"}
    _assert_trees_close(gt, gj, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # every layer of both stacks, and the source projection, gets a gradient
    for side, key in (("enc", "attn"), ("dec", "cross_attn")):
        g = gt[side][key]["wk"]["w"]
        assert bool((g.flatten(1).abs().sum(1) > 0).all())
    assert float(gt["src_proj"]["w"].abs().sum()) > 0


def test_loader_keeps_frame_embeddings_floating():
    """``SyntheticSeq2Seq`` through ``ShardedLoader``: the frame embeddings
    arrive as float32, the tokens and labels as long, all equal to the JAX
    package's data."""
    kw = dict(vocab=50, src_len=16, tgt_len=32, d_frontend=8)
    ds, ds_j = SyntheticSeq2Seq(**kw), JSeq2Seq(**kw)
    host = [ds.batch(3, i) for i in range(2)]
    for i, (h, b) in enumerate(zip(host, ShardedLoader(iter(host), "cpu"))):
        want = ds_j.batch(3, i)
        assert set(b) == set(want) == {"src_embeds", "tokens", "labels"}
        assert b["src_embeds"].dtype == torch.float32
        assert b["tokens"].dtype == b["labels"].dtype == torch.long
        for k, v in b.items():
            np.testing.assert_array_equal(v.numpy(), want[k])
            np.testing.assert_array_equal(v.numpy(), h[k])
