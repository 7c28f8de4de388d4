"""The port's checkpoints against the JAX package's: one ``.npz`` layout, so
a file or an in-memory blob written by either package loads in the other
bit for bit — fp32, fp16, bf16 and fp8 leaves, and AdamW state (the
``OptState`` fields ``.step`` / ``.inner``) after a real update.  Mirrors
the checkpoint cases of ``tests/test_checkpoint_data.py``."""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.elastic import trees_bitexact as j_bitexact  # noqa: E402
from repro.optim import optimizers as j_optim  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch.core.rad import tree_map  # noqa: E402
from repro_torch.elastic import trees_bitexact as t_bitexact  # noqa: E402
from repro_torch.optim import optimizers as t_optim  # noqa: E402

CPU = torch.device("cpu")
DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn")


def _to_torch(a):
    """A JAX (or numpy) array as a tensor of the same dtype, bits kept."""
    a = np.asarray(a)
    name = a.dtype.name
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        width = np.uint16 if name == "bfloat16" else np.uint8
        return torch.from_numpy(a.view(width).copy()).view(
            getattr(torch, name))
    return torch.from_numpy(a.copy())


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return _to_torch(tree)


def _jax_state(dtype, seed=0):
    """Params of mixed shapes, the matrices in ``dtype`` (the rest fp32), and
    the AdamW state after one update with random gradients: step 1,
    non-zero m, v."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    params = {"emb": {"w": jax.random.normal(ks[0], (7, 5))},
              "block_0": {"ln": {"g": jnp.ones(5)},
                          "mlp": {"w": jax.random.normal(ks[1], (5, 3)),
                                  "b": jnp.zeros(3)}},
              "a": {"w": jax.random.normal(ks[2], ())}}
    opt = j_optim.adamw(lr=1e-2)
    st = opt.init(params)
    grads = jax.tree_util.tree_map(
        lambda p: jax.random.normal(ks[3], p.shape), params)
    params, st = opt.update(grads, st, params)
    # fp8 has no arithmetic in JAX: the update runs in fp32, then the
    # matrices are stored in ``dtype``
    params = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if x.ndim == 2 else x, params)
    return params, st


def _torch_templates(params_j):
    params = _tree_to_torch(params_j)
    opt = t_optim.adamw(lr=1e-2).init(params)
    return params, opt


def _state_to_torch(params_j, st_j):
    params = _tree_to_torch(params_j)
    st = t_optim.OptState(step=_to_torch(st_j.step),
                          inner=_tree_to_torch(st_j.inner))
    return params, st


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_blob_loads_in_the_port_bit_for_bit(dtype):
    params_j, st_j = _jax_state(dtype)
    blob = j_ckpt.serialize_state(params_j, st_j)
    tmpl_p, tmpl_o = _torch_templates(params_j)
    params, st = t_ckpt.deserialize_state(blob, tmpl_p, tmpl_o)
    want_p, want_o = _state_to_torch(params_j, st_j)
    assert t_bitexact(params, want_p)
    assert t_bitexact(st, want_o)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert int(st.step) == 1
    assert params["emb"]["w"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_blob_loads_in_jax_bit_for_bit(dtype):
    params_j, st_j = _jax_state(dtype, seed=1)
    params_t, st_t = _state_to_torch(params_j, st_j)
    blob = t_ckpt.serialize_state(params_t, st_t)
    zero_p = jax.tree_util.tree_map(jnp.zeros_like, params_j)
    zero_o = jax.tree_util.tree_map(jnp.zeros_like, st_j)
    params, st = j_ckpt.deserialize_state(blob, zero_p, zero_o)
    assert j_bitexact(params, params_j)
    assert j_bitexact(st, st_j)
    # one layout: the same members, and (stored, same headers) the same size
    jblob = j_ckpt.serialize_state(params_j, st_j)
    with np.load(io.BytesIO(blob)) as a, np.load(io.BytesIO(jblob)) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt/.step" in a.files and "opt/.inner/m/emb/w" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert np.array_equal(a[k], b[k], equal_nan=True)
    assert len(blob) == len(jblob)


def test_params_only_blob_and_sgd_state_cross_both_ways():
    params_j, _ = _jax_state("float32", seed=2)
    params_t = _tree_to_torch(params_j)
    p, o = j_ckpt.deserialize_state(
        t_ckpt.serialize_state(params_t),
        jax.tree_util.tree_map(jnp.zeros_like, params_j))
    assert o is None and j_bitexact(p, params_j)
    opt_j = j_optim.sgd(lr=1e-2, momentum=0.9)
    st_j = opt_j.update(jax.tree_util.tree_map(jnp.ones_like, params_j),
                        opt_j.init(params_j), params_j)[1]
    tmpl = t_optim.sgd(lr=1e-2, momentum=0.9).init(params_t)
    p, st = t_ckpt.deserialize_state(j_ckpt.serialize_state(params_j, st_j),
                                     params_t, tmpl)
    assert t_bitexact(p, params_t)
    assert t_bitexact(st, t_optim.OptState(step=_to_torch(st_j.step),
                                           inner=_tree_to_torch(st_j.inner)))
    # plain SGD has no inner state: ``None`` has no leaves on either side
    st0 = t_optim.sgd(lr=1e-2, momentum=0.0).init(params_t)
    with np.load(io.BytesIO(t_ckpt.serialize_state(params_t, st0))) as z:
        assert [k for k in z.files if k.startswith("opt/")] == ["opt/.step"]


def test_checkpoint_files_cross_and_roundtrip(tmp_path):
    params_j, st_j = _jax_state("bfloat16", seed=3)
    params_t, st_t = _state_to_torch(params_j, st_j)
    d_j, d_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_ckpt.save_checkpoint(d_j, 7, params_j, st_j, metadata={"who": "jax"})
    t_ckpt.save_checkpoint(d_t, 3, params_t, st_t, metadata={"who": "port"})
    t_ckpt.save_checkpoint(d_t, 12, params_t, st_t)
    assert t_ckpt.latest_checkpoint(d_t).endswith("ckpt_00000012.npz")
    assert t_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    # JAX file -> port
    tmpl_p, tmpl_o = _torch_templates(params_j)
    p, o, meta = t_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(d_j),
                                        tmpl_p, tmpl_o)
    assert meta == {"who": "jax", "step": 7}
    assert t_bitexact(p, params_t) and t_bitexact(o, st_t)
    # port file -> JAX, and the port's own round trip
    path = str(tmp_path / "torch" / "ckpt_00000003.npz")
    pj, oj, meta = j_ckpt.load_checkpoint(
        path, jax.tree_util.tree_map(jnp.zeros_like, params_j),
        jax.tree_util.tree_map(jnp.zeros_like, st_j))
    assert meta == {"who": "port", "step": 3}
    assert j_bitexact(pj, params_j) and j_bitexact(oj, st_j)
    with open(path.replace(".npz", ".json")) as f:
        assert json.load(f)["step"] == 3
    p2, o2, _ = t_ckpt.load_checkpoint(path, tmpl_p, tmpl_o)
    assert t_bitexact(p2, params_t) and t_bitexact(o2, st_t)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    params = {"a": {"w": torch.ones(3, 4)}}
    path = t_ckpt.save_checkpoint(str(tmp_path), 1, params)
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_checkpoint(path, {"a": {"w": torch.ones(4, 3)}})
    with pytest.raises(KeyError):
        t_ckpt.load_checkpoint(path, {"b": {"w": torch.ones(3, 4)}})


def test_restore_takes_the_templates_dtype_and_device():
    """Each leaf is cast to its template's dtype and put on its template's
    device: the state restored for a model on the card is on the card."""
    params = {"w": torch.randn(4, 4).to(torch.bfloat16), "b": torch.ones(4)}
    blob = t_ckpt.serialize_state(params)
    meta = {"w": torch.empty(4, 4, dtype=torch.bfloat16, device="meta"),
            "b": torch.empty(4, dtype=torch.float64, device="meta")}
    out, _ = t_ckpt.deserialize_state(blob, meta)
    assert out["w"].device.type == "meta" and out["w"].dtype == torch.bfloat16
    assert out["b"].dtype == torch.float64
    back, _ = t_ckpt.deserialize_state(blob, tree_map(torch.zeros_like,
                                                      params))
    assert t_bitexact(back, params)
