"""The port's abstract step inputs (``distributed/steps.py``: ``src_len_for``,
``input_specs``, ``decode_window``, ``decode_state_specs``) and analytic
model FLOPs (``analysis/model_flops.py``) against the JAX package, for
every arch × input shape, on the CPU.

The specs are ``meta`` tensors in the port and ``ShapeDtypeStruct``s in
JAX: their trees, shapes and dtypes must be equal.  The FLOP counts are
Python arithmetic in both packages and must be exactly equal.  No
tolerance is involved.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import model_flops as j_mf  # noqa: E402
from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import resolve as j_resolve  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro_torch import analysis as t_mf  # noqa: E402
from repro_torch.analysis.model_flops import _attn  # noqa: E402
from repro_torch.configs import INPUT_SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import InputShape  # noqa: E402
from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.core.rad import tree_map  # noqa: E402
from repro_torch.distributed import steps as t_steps  # noqa: E402
from repro_torch.models import causal_lm, encdec  # noqa: E402

# every (arch, shape) the registry applies (the JAX tests skip the rest)
COMBOS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
          if s in j_resolve(a).shapes]
DECODES = [(a, s) for a, s in COMBOS if INPUT_SHAPES[s].kind == "decode"]
ALL = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


def _sig(tree):
    """{key: sig} down to (shape, dtype name) at the leaves, for either
    package's abstract trees."""
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]
    return tuple(tree.shape), np.dtype(tree.dtype).name


def _shape_pair(name):
    return INPUT_SHAPES[name], T_SHAPES[name]


def test_input_shapes_equal_jax():
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in T_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind)
         for k, s in INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_input_specs_and_src_len_match_jax(arch, shape_name):
    cfg_j, cfg_t = j_resolve(arch).full, t_resolve(arch).full
    sj, st = _shape_pair(shape_name)
    spec_t = t_steps.input_specs(cfg_t, st)
    assert _sig(spec_t) == _sig(j_steps.input_specs(cfg_j, sj))
    assert spec_t["tokens"].dtype == torch.int32
    B = st.global_batch
    if cfg_t.family == "encdec":
        S_src = t_steps.src_len_for(cfg_t, st.seq_len)
        assert S_src == j_steps.src_len_for(cfg_j, sj.seq_len) == \
            max(st.seq_len // 8, 16)
        assert spec_t["src_embeds"].shape == (B, S_src, cfg_t.d_frontend)
        assert spec_t["src_embeds"].dtype == cfg_t.dtype
        assert spec_t["tokens"].shape == (B, st.seq_len)
    if st.kind == "train":
        assert spec_t["labels"].shape == spec_t["tokens"].shape
    assert t_steps.decode_window(cfg_t, st) == \
        j_steps.decode_window(cfg_j, sj)


@pytest.mark.parametrize("arch,shape_name", DECODES)
def test_decode_state_specs_match_jax(arch, shape_name):
    cfg_j, cfg_t = j_resolve(arch).full, t_resolve(arch).full
    sj, st = _shape_pair(shape_name)
    assert _sig(t_steps.decode_state_specs(cfg_t, st)) == \
        _sig(j_steps.decode_state_specs(cfg_j, sj))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if "decode_32k" in j_resolve(a).shapes])
def test_decode_state_specs_match_the_real_cache(arch):
    """At smoke size the abstract cache has the tree, shapes and dtypes of
    the cache the model builds (``tests/test_distributed.py``'s check)."""
    cfg = t_resolve(arch).smoke
    shape = InputShape("decode_32k", 32, 2, "decode")
    if cfg.family == "encdec":
        real = encdec.cache_init(cfg, 2, 32, t_steps.src_len_for(cfg, 32),
                                 device="cpu")
    else:
        real = causal_lm.cache_init(cfg, 2, 32, device="cpu")
    assert _sig(t_steps.decode_state_specs(cfg, shape)) == \
        _sig(tree_map(lambda t: t.to("meta"), real))


# ------------------------------------------------------------------ flops --
@pytest.mark.parametrize("arch,shape_name", ALL)
def test_model_flops_equal_jax(arch, shape_name):
    cfg_j, cfg_t = j_resolve(arch).full, t_resolve(arch).full
    sj, st = _shape_pair(shape_name)
    B, S = st.global_batch, st.seq_len
    assert t_mf.model_flops(cfg_t, st) == j_mf.model_flops(cfg_j, sj)
    assert t_mf.forward_flops(cfg_t, B, S) == j_mf.forward_flops(cfg_j, B, S)
    assert t_mf.forward_flops(cfg_t, B, 1, kv_len=S, decode=True) == \
        j_mf.forward_flops(cfg_j, B, 1, kv_len=S, decode=True)
    assert t_mf.six_nd(cfg_t, B * S) == j_mf.six_nd(cfg_j, B * S)
    # and at smoke size, where the windows and vocabularies differ
    sm_j, sm_t = j_resolve(arch).smoke, t_resolve(arch).smoke
    assert t_mf.model_flops(sm_t, st) == j_mf.model_flops(sm_j, sj)
    assert t_mf.six_nd(sm_t, 1000) == j_mf.six_nd(sm_j, 1000)


def test_encdec_flops_keep_the_references_decode_source_length():
    """A decode's cross-attention is counted over ``kv_len`` source frames,
    as the JAX package counts it, and no encoder runs."""
    cfg = t_resolve("seamless-m4t-large-v2").full
    f = t_mf.forward_flops(cfg, 1, 1, kv_len=512, decode=True)
    per_dec = (_attn(1, 512, cfg, causal=False) * 2
               + 2.0 * cfg.d_model * cfg.d_ff * 2)
    assert f == 2.0 * cfg.d_model * cfg.vocab_padded \
        + cfg.n_dec_layers * per_dec
    assert t_mf.six_nd(cfg, 10) == 6.0 * encdec.count_params(cfg) * 10


@pytest.mark.parametrize("arch_id", ["llama3-8b", "granite-3-8b",
                                     "mistral-nemo-12b"])
def test_model_flops_close_to_6nd_for_dense_train(arch_id):
    """``tests/test_analysis.py``'s check on the port: the per-block
    accounting lands within 35 % of 6ND for dense archs at train_4k."""
    cfg = t_resolve(arch_id).full
    shape = T_SHAPES["train_4k"]
    ours = t_mf.model_flops(cfg, shape)
    nd = t_mf.six_nd(cfg, shape.seq_len * shape.global_batch)
    assert 0.65 < ours / nd < 1.35, (ours, nd)


def test_decode_flops_much_smaller_than_train():
    cfg = t_resolve("llama3-8b").full
    f_train = t_mf.model_flops(cfg, T_SHAPES["train_4k"])
    f_dec = t_mf.model_flops(cfg, T_SHAPES["decode_32k"])
    assert f_dec < f_train / 1000


def test_window_caps_decode_attention_flops():
    cfg = t_resolve("llama3-8b").full
    full = t_mf.forward_flops(cfg, 1, 1, kv_len=524_288, decode=True)
    win = t_mf.forward_flops(cfg.replace(window=4096), 1, 1, kv_len=524_288,
                             decode=True)
    assert win < full
