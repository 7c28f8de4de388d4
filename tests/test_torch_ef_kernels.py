"""The error-feedback encode and the dense Top-K masks of the port against
the JAX package's, bit for bit.

The port's plain versions of ``ef_encode_topk``, ``blockwise_topk_mask``
and ``ef_topk`` (what the CUDA kernels compute, and what the wrappers run
for a CPU tensor) must give the same values, bitmap words and residuals as
the JAX package's plain versions and its Pallas kernels in interpret mode,
in fp32, bf16 and fp16.  So must the entry points (``ops.topk_mask``,
``ops.blockwise_topk_mask``, ``ops.ef_topk``, ``ef_compress`` under
``"auto"``).  Inputs come from numpy with a seed; they are finite, since the
dense EF kernel's ``c - sent`` and the EF encode's ``kept ? 0 : c`` agree
only there.  The CUDA kernels themselves are held against the plain
versions in ``test_torch_cuda_kernels.py``, which needs a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import topk_compress as jtk  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import topk_compress as ttk  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
BLOCK = 512
LEVELS = np.array([-1.0, -0.5, -0.0, 0.0, 0.5, 1.0], np.float32)


def _draw(rng, shape, regime):
    if regime == "zeros":
        return np.zeros(shape, np.float32)
    if regime == "ties":
        return rng.choice(LEVELS, size=shape)
    return rng.standard_normal(shape).astype(np.float32)


def _pair(shape, dtype, regime="normal", seed=0):
    """x and a residual drawn like it, for both frameworks."""
    rng = np.random.default_rng(seed)
    x, r = _draw(rng, shape, regime), _draw(rng, shape, regime)
    jd, td = DTYPES[dtype]
    return ((jnp.asarray(x, dtype=jd), jnp.asarray(r, dtype=jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(r).to(td)))


def _bits(a):
    """int32 bit patterns of a float tensor or array widened to float32
    (exact for bf16/f16; keeps -0.0 apart from 0.0); bitmap words as they
    are."""
    if isinstance(a, torch.Tensor):
        if not a.is_floating_point():
            return a.numpy().view(np.uint32)
        return a.to(torch.float32).numpy().view(np.int32)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a
    return a.astype(np.float32).view(np.int32)


def _assert_same(t_out, j_out):
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(_bits(t), _bits(j))


CASES = [((64,), 1, "normal"), ((4096,), 7, "normal"),
         ((5000,), 40, "normal"), ((32, 257), 512, "normal"),
         ((8, 128, 17), 3, "normal"), ((3000,), 9, "ties"),
         ((1000,), 5, "zeros"), ((700,), 600, "normal")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kpb,regime", CASES)
def test_dense_and_ef_plain_match_jax_plain(shape, kpb, regime, dtype):
    (xj, rj), (xt, rt) = _pair(shape, dtype, regime, seed=kpb + len(shape))
    _assert_same(tref.blockwise_topk_mask_ref(xt, kpb, block=BLOCK),
                 jref.blockwise_topk_mask_ref(xj, kpb, block=BLOCK))
    _assert_same(tref.ef_topk_ref(xt, rt, kpb, block=BLOCK),
                 jref.ef_topk_ref(xj, rj, kpb, block=BLOCK))
    _assert_same(tref.ef_encode_topk_ref(xt, rt, kpb, block=BLOCK),
                 jref.ef_encode_topk_ref(xj, rj, kpb, block=BLOCK))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kpb,regime",
                         [((1500,), 40, "normal"), ((1200,), 9, "ties"),
                          ((64,), 1, "zeros"), ((700,), 512, "normal")])
def test_dense_and_ef_match_pallas_interpret(shape, kpb, regime, dtype):
    (xj, rj), (xt, rt) = _pair(shape, dtype, regime, seed=kpb)
    # on the CPU the wrappers take the plain versions
    _assert_same(ttk.blockwise_topk_mask(xt, kpb, block=BLOCK),
                 jtk.blockwise_topk_mask(xj, kpb, block=BLOCK,
                                         interpret=True))
    _assert_same(ttk.ef_topk(xt, rt, kpb, block=BLOCK),
                 jtk.ef_topk(xj, rj, kpb, block=BLOCK, interpret=True))
    _assert_same(ttk.ef_encode_topk(xt, rt, kpb, block=BLOCK),
                 jtk.ef_encode_topk(xj, rj, kpb, block=BLOCK,
                                    interpret=True))


def test_default_block_with_k_of_one_and_full():
    (xj, rj), (xt, rt) = _pair((9000,), "float32", seed=5)
    for kpb in (1, 4096, 10_000):
        _assert_same(tref.blockwise_topk_mask_ref(xt, kpb),
                     jref.blockwise_topk_mask_ref(xj, kpb))
        _assert_same(tref.ef_topk_ref(xt, rt, kpb),
                     jref.ef_topk_ref(xj, rj, kpb))
        _assert_same(tref.ef_encode_topk_ref(xt, rt, kpb),
                     jref.ef_encode_topk_ref(xj, rj, kpb))


def test_dense_mask_keeps_every_tie_and_the_padding_at_threshold_zero():
    x = torch.tensor([1.0, -1.0, 1.0, 0.5] + [0.0] * 28)
    kept = tref.blockwise_topk_mask_ref(x, 2, block=32)
    assert tref.count_kept(kept) == 3                 # superset of k = 2
    assert tref.count_kept(tref.encode_topk_ref(x, 2, block=32)[0]) == 2
    y = torch.tensor([-0.0, 2.0, -0.0])               # 29 padding zeros
    out = tref.blockwise_topk_mask_ref(y, 32, block=32)
    np.testing.assert_array_equal(_bits(out), _bits(y))   # -0.0 kept as is


def test_residual_promotes_on_the_cpu_as_in_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(1500).astype(np.float32)
    r = rng.standard_normal(1500).astype(np.float32) * 0.1
    xt, rt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(r)
    xj, rj = jnp.asarray(x, dtype=jnp.bfloat16), jnp.asarray(r)
    t_out = tref.ef_topk_ref(xt, rt, 20, block=BLOCK)
    assert t_out[0].dtype == torch.float32
    _assert_same(t_out, jref.ef_topk_ref(xj, rj, 20, block=BLOCK))
    _assert_same(tref.ef_encode_topk_ref(xt, rt, 20, block=BLOCK),
                 jref.ef_encode_topk_ref(xj, rj, 20, block=BLOCK))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_entry_points_match_jax(dtype):
    (xj, rj), (xt, rt) = _pair((6, 1000), dtype, seed=11)
    for k in (1, 60, 6000):
        _assert_same(tops.topk_mask(xt, k, block=BLOCK),
                     jops.topk_mask(xj, k, block=BLOCK))
    for kpb in (1, 9, 512):
        _assert_same(tops.blockwise_topk_mask(xt, kpb, block=BLOCK),
                     jops.blockwise_topk_mask(xj, kpb, block=BLOCK))
        _assert_same(tops.ef_topk(xt, rt, kpb, block=BLOCK),
                     jops.ef_topk(xj, rj, kpb, block=BLOCK))
        _assert_same(tops.ef_encode_topk(xt, rt, kpb, block=BLOCK),
                     jops.ef_encode_topk(xj, rj, kpb, block=BLOCK))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ef_compress_auto_matches_jax_over_carried_steps(dtype):
    rng = np.random.default_rng(3)
    jd, td = DTYPES[dtype]
    st = tcomp.ErrorFeedbackState.init(torch.zeros(3000, dtype=td))
    js = jcomp.ErrorFeedbackState.init(jnp.zeros(3000, dtype=jd))
    for _ in range(4):
        x = rng.standard_normal(3000).astype(np.float32)
        sent, st = tcomp.ef_compress(torch.from_numpy(x).to(td), st, 50,
                                     "auto")
        jsent, js = jcomp.ef_compress(jnp.asarray(x, dtype=jd), js, 50,
                                      "auto")
        _assert_same((sent, st.residual), (jsent, js.residual))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ef_compress_equals_the_ef_step_composition(dtype):
    """What kernel 4 computes is what rad.pipeline_loss_and_grad_ef composes
    from ``g + r``, the codec ``topk_mask`` and the difference."""
    rng = np.random.default_rng(4)
    td = DTYPES[dtype][1]
    st = tcomp.ErrorFeedbackState.init(torch.zeros(5, 700, dtype=td))
    r = torch.zeros(5, 700, dtype=td)
    for _ in range(5):
        x = torch.from_numpy(_draw(rng, (5, 700), "normal")).to(td)
        sent, st = tcomp.ef_compress(x, st, 35, "auto")
        c = x + r
        want = tcomp.topk_mask(c, 35, use_kernel="auto")
        r = c - want
        _assert_same((sent, st.residual), (want, r))


def test_count_kept_matches_jax():
    (xj, _), (xt, _) = _pair((3000,), "bfloat16", "ties", seed=1)
    assert tref.count_kept(xt) == jref.count_kept(xj) > 0
    assert tref.count_kept(torch.zeros(7)) == 0


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    ttk.reset_launch_counts()
    _, (xt, rt) = _pair((5000,), "float32", seed=3)
    _assert_same(ttk.blockwise_topk_mask(xt, 5, block=BLOCK),
                 tref.blockwise_topk_mask_ref(xt, 5, block=BLOCK))
    _assert_same(ttk.ef_topk(xt, rt, 5, block=BLOCK),
                 tref.ef_topk_ref(xt, rt, 5, block=BLOCK))
    _assert_same(ttk.ef_encode_topk(xt, rt, 5, block=BLOCK),
                 tref.ef_encode_topk_ref(xt, rt, 5, block=BLOCK))
    tops.codec_ef_topk(xt, rt, 100, mode="plain", block=BLOCK)
    assert all(f.launches == 0 for f in ttk.KERNELS.values())
    assert set(ttk.KERNELS) == {"encode_topk", "ef_encode_topk",
                                "decode_topk", "blockwise_topk_mask",
                                "ef_topk"}


def test_bad_dtype_and_block_raise():
    x = torch.ones(64)
    for call in (lambda: ttk.blockwise_topk_mask(x, 4, block=48),
                 lambda: ttk.ef_topk(x, x, 4, block=48),
                 lambda: ttk.ef_encode_topk(x, x, 4, block=48)):
        with pytest.raises(ValueError, match="multiple of 32"):
            call()
    with pytest.raises(TypeError):
        ttk.blockwise_topk_mask(x.double(), 4)
