"""The port's mesh, sharding rules, override sets, roofline and step
assembler (``launch/mesh.py``, ``distributed/sharding.py``, ``params.py``,
``steps.py``'s ``cache_shardings`` / ``batch_shardings`` /
``abstract_params`` / ``build_jitted``, ``perf/``, ``analysis/roofline.py``)
against the JAX package, on the CPU.

The JAX side takes ``jax.sharding.AbstractMesh`` for the production meshes
(16 × 16 and 2 × 16 × 16: no devices needed); the port takes its own
production meshes, which hold no devices.  For every arch × input shape the
registry applies, the shardings ``build_jitted`` gives every argument — the
parameters (with and without the ``moe_w`` overrides), the optimizer state,
the batch, the decode cache and tokens, and the cache a prefill returns —
must equal the ones JAX's ``build_jitted`` jits its step with, leaf by
leaf, by path: the spec, and the shard shape (or the same refusal to
split).  The specs are Python arithmetic in both packages: no tolerance.

``build_jitted`` on the one-device local mesh runs a train step at smoke
size from JAX's weights: the loss and ``grad_norm`` within rtol 1e-5, the
updated parameters within rtol 1e-4 (atol 1e-6), as ``test_torch_gspmd``
holds Adafactor.  Except: an entry whose gradient is at the rounding level
of its leaf (|g| at most 1e-7 of the leaf's largest, where two summation
orders in fp32 disagree in every digit) is held within the largest move
Adafactor's RMS clip allows, lr × sqrt(leaf size), and the leaf's other
entries are held up to one scale.  Adafactor's factored second moment
normalizes such a row of the leaf by its own tiny scale, so each framework
moves it by O(lr) in a sign set by rounding noise, and the leaf-wide RMS
clip then scales every move of the leaf by a factor that noise sets.  At
xlstm-smoke that is the sLSTM's input-gate bias row (``groups/s/slstm/b``
row 1: |g| <= 7e-10 against 0.040 in row 0; the frameworks differ by
9e-10 there, and the updates by 8.7 × lr).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.analysis import roofline as j_roof  # noqa: E402
from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import resolve as j_resolve  # noqa: E402
from repro.distributed import params as j_params  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro.perf import overrides as j_ov  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.analysis import roofline as t_roof  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs import INPUT_SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core.opgraph import tree_leaves  # noqa: E402
from repro_torch.distributed import params as t_params  # noqa: E402
from repro_torch.distributed import sharding as t_sh  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.perf import overrides as t_ov  # noqa: E402
from test_torch_models import _np_tree  # noqa: E402

CPU = torch.device("cpu")
COMBOS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
          if s in j_resolve(a).shapes]
MOE = [a for a in ARCH_IDS if j_resolve(a).full.family == "moe"]
PROD = {"pod": ((16, 16), ("data", "model")),
        "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _prod_meshes(name):
    shape, axes = PROD[name]
    tm = t_mesh.make_production_mesh(multi_pod=name == "multipod")
    assert tuple(tm.shape.values()) == shape and tm.axis_names == axes
    assert tm.devices is None and tm.size == int(np.prod(shape))
    return tm, AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return (t_steps.abstract_params(t_resolve(arch).full),
            j_steps.abstract_params(j_resolve(arch).full))


def _t_flat(tree):
    out = {}
    t_params.tree_map_with_path(
        lambda p, leaf: out.__setitem__(t_params.tree_path_str(p), leaf),
        tree)
    return out


def _j_flat(tree):
    return {j_params.tree_path_str(p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _shard_shape(sharding, shape):
    try:
        return sharding.shard_shape(shape)
    except ValueError:
        return "indivisible"


def _assert_same_shardings(t_tree, j_tree, j_abstract):
    """Leaf by leaf, by path: the spec and the shard shape of the leaf."""
    t, j = _t_flat(t_tree), _j_flat(j_tree)
    shapes = {k: tuple(v.shape) for k, v in _j_flat(j_abstract).items()}
    assert t.keys() == j.keys() == shapes.keys()
    for key, js in j.items():
        ts = t[key]
        assert isinstance(ts, t_sh.NamedSharding)
        assert tuple(ts.spec) == tuple(js.spec), key
        assert _shard_shape(ts, shapes[key]) == \
            _shard_shape(js, shapes[key]), key


def _sig_t(tree):
    """{path: (shape, dtype name)} of the port's abstract tree, every leaf
    a ``meta`` tensor."""
    out = {}
    for key, leaf in _t_flat(tree).items():
        assert leaf.device.type == "meta", key
        out[key] = (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
    return out


def _sig_j(tree):
    return {key: (tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for key, leaf in _j_flat(tree).items()}


def _j_in_shardings(fn):
    info = fn._jit_info
    return jax.tree_util.tree_unflatten(info.in_shardings_treedef,
                                        info.in_shardings_leaves)


def _j_out_shardings(fn):
    info = fn._jit_info
    return jax.tree_util.tree_unflatten(info.out_shardings_treedef,
                                        info.out_shardings_leaves)


# ================================================= production meshes ==
@pytest.mark.parametrize("mesh_name", list(PROD))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_jax(arch, mesh_name):
    tm, jm = _prod_meshes(mesh_name)
    p_t, p_j = _abstract(arch)
    _assert_same_shardings(t_params.param_shardings(p_t, tm),
                           j_params.param_shardings(p_j, jm), p_j)


@pytest.mark.parametrize("mesh_name", list(PROD))
@pytest.mark.parametrize("arch", MOE)
def test_param_shardings_with_moe_w_match_jax(arch, mesh_name):
    tm, jm = _prod_meshes(mesh_name)
    p_t, p_j = _abstract(arch)
    t_over = t_ov.get("moe_w")["param_overrides"]
    j_over = j_ov.get("moe_w")["param_overrides"]
    t_tree = t_params.param_shardings(p_t, tm, overrides=t_over)
    _assert_same_shardings(
        t_tree, j_params.param_shardings(p_j, jm, overrides=j_over), p_j)
    moe_leaves = [k for k in _t_flat(t_tree) if "/moe/" in k]
    assert moe_leaves and all(
        tuple(_t_flat(t_tree)[k].spec) in ((None, None, None, "model"),
                                           (None, None, "model", None))
        for k in moe_leaves if k.rsplit("/", 1)[-1] in ("gate", "up",
                                                       "down"))


@pytest.mark.parametrize("mesh_name", list(PROD))
@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_build_jitted_shardings_match_jax(arch, shape_name, mesh_name):
    """Every argument's shardings (and a prefill's returned cache's) equal
    those JAX's ``build_jitted`` jits the step with; the abstract arguments
    equal JAX's in tree, shape and dtype."""
    tm, jm = _prod_meshes(mesh_name)
    cfg_t, cfg_j = t_resolve(arch).full, j_resolve(arch).full
    fn_t, args_t, meta_t = t_steps.build_jitted(cfg_t, tm,
                                                T_SHAPES[shape_name])
    fn_j, args_j, meta_j = j_steps.build_jitted(cfg_j, jm,
                                                INPUT_SHAPES[shape_name])
    assert callable(fn_t) and len(args_t) == len(args_j)
    for a_t, a_j in zip(args_t, args_j):
        assert _sig_t(a_t) == _sig_j(a_j)
    _assert_same_shardings(meta_t["param_sh"], meta_j["param_sh"], args_j[0])
    in_j = _j_in_shardings(fn_j)
    assert len(meta_t["in_shardings"]) == len(in_j) == len(args_j)
    for sh_t, sh_j, a_j in zip(meta_t["in_shardings"], in_j, args_j):
        if isinstance(sh_j, JNamedSharding):          # the decode tokens
            sh_t, sh_j, a_j = {"t": sh_t}, {"t": sh_j}, {"t": a_j}
        _assert_same_shardings(sh_t, sh_j, a_j)
    if INPUT_SHAPES[shape_name].kind == "prefill":
        cache_j = j_steps.decode_state_specs(cfg_j, INPUT_SHAPES[shape_name])
        _assert_same_shardings(meta_t["cache_sh"], _j_out_shardings(fn_j)[1],
                               cache_j)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_are_meta_and_equal_jax_eval_shape(arch):
    """Full size, every arch: the tree, shapes and dtypes of JAX's
    ``eval_shape`` of ``init``, on the ``meta`` device (no storage)."""
    p_t, p_j = _abstract(arch)
    assert _sig_t(p_t) == _sig_j(p_j)
    assert all(t.device.type == "meta" for t in tree_leaves(p_t))


def test_init_keeps_the_generators_device_by_default():
    from repro_torch.models import causal_lm
    cfg = t_resolve("zamba2-7b").smoke
    a = causal_lm.init(cfg, torch.Generator().manual_seed(3))
    b = causal_lm.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    m = causal_lm.init(cfg, torch.Generator().manual_seed(3), device="meta")
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(m)):
        assert x.device == CPU and torch.equal(x, y)
        assert z.device.type == "meta" and z.shape == x.shape \
            and z.dtype == x.dtype


# ======================================================== rule edges ==
SMALL_MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
                ((2, 8), ("data", "model")), ((3,), ("data",)),
                ((8,), ("model",)), ((2, 4), ("pod", "model")),
                ((2, 3, 4), ("pod", "data", "model")),
                ((4, 1, 1), ("pod", "data", "model"))]
SHAPES = [(), (7,), (8,), (1, 8), (6, 4), (16, 16), (4, 3, 8), (2, 1),
          (3, 12), (12, 3, 2, 8)]


@pytest.mark.parametrize("shape,axes", SMALL_MESHES)
def test_generic_row_and_batch_specs_match_jax(shape, axes):
    tm = t_sh.Mesh(shape, axes)
    jm = AbstractMesh(shape, axes)
    for s in SHAPES:
        assert tuple(t_params.generic_spec(s, tm)) == \
            tuple(j_params.generic_spec(s, jm)), s
        assert tuple(t_params.generic_spec(s, tm, "data", "model")) == \
            tuple(j_params.generic_spec(s, jm, "data", "model")), s
        assert tuple(t_params.row_spec(s, tm)) == \
            tuple(j_params.row_spec(s, jm)), s
    for b in (1, 2, 3, 4, 6, 8, 12, 16, 24, 256):
        assert tuple(t_params.batch_spec(b, tm)) == \
            tuple(j_params.batch_spec(b, jm)), b


def test_partition_spec_equality_is_jaxs():
    P = t_sh.P
    assert P("data") == P(("data",)) == ("data",) == P(["data"])
    assert P(("pod", "data")) == (("pod", "data"),)
    assert P("data") == (("data",),)
    assert P(()) == P(None) and P(None) != P()
    assert P("a", None) != P("a")
    assert hash(P("data")) == hash(P(("data",)))
    assert repr(P(None, ("a", "b"))) == repr(JP(None, ("a", "b")))
    for parts in [("data",), (("data",),), ((),), (None, ("a", "b")), ()]:
        assert tuple(P(*parts)) == tuple(JP(*parts))


def test_named_sharding_and_shard_shape():
    tm = t_sh.Mesh((2, 16, 16), ("pod", "data", "model"))
    jm = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for spec, shape in [(("data", None), (32, 8)),
                        ((("pod", "data"), "model"), (64, 32)),
                        ((None, "model"), (3, 16)), ((), (5, 5)),
                        (("data",), (33,)), ((("pod", "model"),), (64, 2))]:
        ts = t_sh.NamedSharding(tm, t_sh.P(*spec))
        js = JNamedSharding(jm, JP(*spec))
        assert _shard_shape(ts, shape) == _shard_shape(js, shape)
    with pytest.raises(ValueError):
        t_sh.NamedSharding(tm, t_sh.P("expert"))
    for axes in [("batch", None), ("batch", "model"), (None, "vocab")]:
        with j_sh.use_mesh(jm):
            jspec = j_sh.logical_to_spec(axes)
        assert tuple(t_sh.named_sharding(tm, *axes).spec) == tuple(jspec)


RULES = [None] + [j_ov.get(n).get("rules") for n in j_ov.names()]


@pytest.mark.parametrize("shape,axes", SMALL_MESHES)
def test_use_mesh_filters_axes_as_jax(shape, axes):
    tm, jm = t_sh.Mesh(shape, axes), AbstractMesh(shape, axes)
    names = list(j_sh.DEFAULT_RULES) + ["unknown", None]
    assert t_sh.DEFAULT_RULES == j_sh.DEFAULT_RULES
    for rules in RULES:
        with t_sh.use_mesh(tm, rules), j_sh.use_mesh(jm, rules):
            assert t_sh._current()[1] == j_sh._current()[1]
            for n in names:
                assert tuple(t_sh.logical_to_spec([n, "batch"])) == \
                    tuple(j_sh.logical_to_spec([n, "batch"])), n
        assert t_sh._current()[0] is None          # restored on exit
    assert tuple(t_sh.logical_to_spec(["batch"])) == \
        tuple(j_sh.logical_to_spec(["batch"])) == (("pod", "data"),)


def test_constrain_identity_cases_and_refusal():
    x = torch.randn(4, 6)
    assert t_sh.constrain(x, ("batch", "model")) is x            # off-mesh
    with t_sh.use_mesh(t_mesh.make_local_mesh("cpu")):
        assert t_sh.constrain(x, ("batch", "model")) is x        # 1 device
    eight = t_mesh.make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    with t_sh.use_mesh(eight):
        assert t_sh.constrain(x, ("seq", "act_seq")) is x         # all None
        assert t_sh.constrain(x, (None, "expert_dispatch")) is x
        with pytest.raises(ValueError, match="rank"):
            t_sh.constrain(x, ("batch",))
        with pytest.raises(NotImplementedError):
            t_sh.constrain(x, ("batch", None))
    with t_sh.use_mesh(eight, {"act_seq": "model"}):
        with pytest.raises(NotImplementedError):
            t_sh.constrain(x, ("seq", "act_seq"))


# ============================================================ perf sets ==
def _norm_set(kw, spec_type):
    out = {}
    for k, v in kw.items():
        if k == "param_overrides":
            assert all(isinstance(s, spec_type) for s in v.values())
            v = {rx: tuple(s) for rx, s in v.items()}
        out[k] = v
    return out


def test_override_sets_equal_jax():
    assert t_ov.names() == j_ov.names() == sorted(
        ["seqpar", "ep", "ep_seqpar", "moe_w", "seqpar_dots", "moe_ragged",
         "moe_w_seqpar"])
    for name in t_ov.names():
        assert _norm_set(t_ov.get(name), t_sh.PartitionSpec) == \
            _norm_set(j_ov.get(name), type(JP()))
    assert t_ov.get(None) is None and j_ov.get(None) is None
    with pytest.raises(KeyError):
        t_ov.get("nope")


def test_register_adds_a_set():
    t_ov.register("_probe", rules={"act_seq": "model"})
    try:
        assert "_probe" in t_ov.names()
        assert t_ov.get("_probe") == {"rules": {"act_seq": "model"}}
    finally:
        t_ov._SETS.pop("_probe")


# ============================================================= roofline ==
def test_roofline_terms_match_jax_under_an_explicit_spec():
    hw = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    t_hw, j_hw = t_roof.HWSpec(**hw), j_roof.HWSpec(**hw)
    for args in [(3.2e15, 4.1e11, 2.0e10, 5.0e17, 256),
                 (1e9, 5e12, 0.0, None, 1), (1e12, 1e3, 9e12, 1e14, 4),
                 (0.0, 0.0, 0.0, 1e12, 1)]:
        t = t_roof.roofline_terms(*args, hw=t_hw)
        j = j_roof.roofline_terms(*args, hw=j_hw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.dominant, t.bound_time, t.useful_flops_ratio) == \
            (j.dominant, j.bound_time, j.useful_flops_ratio)
        assert t.as_row() == j.as_row()


def test_default_hw_is_the_h100_data_sheet():
    hw = t_roof.HW
    assert (hw.peak_flops, hw.peak_flops_fp32, hw.hbm_bw, hw.link_bw) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert hw.fp32().peak_flops == 67e12 and hw.fp32().hbm_bw == 3.35e12
    t = t_roof.roofline_terms(6.7e12, 3.35e9, 0.0, hw=hw.fp32())
    assert t.compute_s == pytest.approx(0.1) and t.dominant == "compute"


# ============================================================== meshes ==
def test_local_and_explicit_meshes():
    m = t_mesh.make_local_mesh("cpu")
    assert dict(m.shape) == {"data": 1, "model": 1} and m.size == 1
    assert list(m.devices.flat) == [CPU]
    eight = t_mesh.make_mesh((2, 4), ("pod", "model"), [CPU] * 8)
    assert eight.devices.shape == (2, 4) and eight.distinct_devices() == (CPU,)
    with pytest.raises(ValueError):
        t_mesh.make_mesh((2, 4), ("pod", "model"), [CPU] * 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.make_local_mesh()


# =================================================== build_jitted runs ==
LOCAL_ARCHS = ["llama3-8b", "zamba2-7b", "deepseek-moe-16b", "xlstm-1_3b"]


@pytest.mark.parametrize("arch_id", LOCAL_ARCHS)
def test_build_jitted_runs_on_local_mesh(arch_id):
    """The step ``build_jitted`` returns on the local CPU mesh, from JAX's
    weights, against JAX's ``build_jitted`` step (Adafactor)."""
    shape_j = type("S", (), {"seq_len": 16, "global_batch": 2,
                             "kind": "train", "name": "train_4k"})()
    cfg_j, cfg_t = j_resolve(arch_id).smoke, t_resolve(arch_id).smoke
    jm = jax.make_mesh((1, 1), ("data", "model"))
    with j_sh.use_mesh(jm):
        fn_j, _, _ = j_steps.build_jitted(cfg_j, jm, shape_j)
        params = j_lm.init(cfg_j, jax.random.PRNGKey(0))
        rng = jax.random.PRNGKey(1)
        batch = {"tokens": jax.random.randint(rng, (2, 16), 0, cfg_j.vocab),
                 "labels": jax.random.randint(rng, (2, 16), 0, cfg_j.vocab)}
        if cfg_j.n_prefix:
            batch["prefix_embeds"] = jax.random.normal(
                rng, (2, cfg_j.n_prefix, cfg_j.d_frontend))
        p_np = _np_tree(params)         # the step donates its params
        p_j, _, m_j = fn_j(params, j_optim.adafactor(1e-3).init(params),
                           batch)
    tm = t_mesh.make_local_mesh("cpu")
    fn_t, args_t, meta = t_steps.build_jitted(
        cfg_t, tm, t_steps.InputShape("train_4k", 16, 2, "train"))
    assert _sig_t(args_t[0]) == _sig_j(jax.eval_shape(
        lambda: j_lm.init(cfg_j, jax.random.PRNGKey(0))))
    p_t = from_numpy_tree(p_np, CPU)
    b_t = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    b_t["tokens"], b_t["labels"] = b_t["tokens"].long(), b_t["labels"].long()
    with t_sh.use_mesh(tm):
        p2, o2, m_t = fn_t(p_t, t_optim.adafactor(1e-3).init(p_t), b_t)
    assert np.isfinite(float(m_t["loss"]))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=1e-5)
    _, _, g_t = t_steps.loss_and_grad(cfg_t, from_numpy_tree(p_np, CPU), b_t)
    _assert_adafactor_params_close(p2, p_j, g_t, p_np, lr=1e-3)
    assert int(o2.step) == 1


def _assert_adafactor_params_close(t_tree, j_tree, grads, p0, lr):
    """``grads``: the port's gradients at ``p0`` (they find the entries at
    the rounding level)."""
    t, j, g, p0 = (_j_flat(to_numpy_tree(t_tree)), _j_flat(_np_tree(j_tree)),
                   _j_flat(to_numpy_tree(grads)), _j_flat(p0))
    assert t.keys() == j.keys() == g.keys() == p0.keys()
    for key, b in j.items():
        a = t[key]
        noise = np.abs(g[key]) <= 1e-7 * np.abs(g[key]).max()
        if not noise.any():
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
            continue
        # the RMS clip carries the noise entries' moves to the whole
        # leaf: the other entries' moves agree up to one scale
        d_t, d_j = (a - p0[key])[~noise], (b - p0[key])[~noise]
        scale = float((d_t * d_j).sum() / (d_j * d_j).sum())
        assert np.abs(d_t - scale * d_j).max() <= \
            1e-4 * np.abs(d_j).max(), key
        assert np.all(np.abs(a - b) <= lr * np.sqrt(b.size)), key


def test_build_jitted_refuses_several_devices():
    two = t_mesh.make_mesh((2, 1), ("data", "model"),
                           [torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="one device"):
        t_steps.build_jitted(t_resolve("gpt2-xl").smoke, two,
                             T_SHAPES["train_4k"])
