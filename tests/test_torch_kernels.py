"""The port's wire codec against the JAX package's, bit for bit.

The plain PyTorch encode/decode (what the CUDA kernels compute, and what the
wrappers run for a CPU tensor) must give the same values and the same
bitmap words as the JAX package's plain versions and as its Pallas kernels
in interpret mode.  Inputs come from numpy with a seed.  The CUDA kernels
themselves are held against the plain versions in
``test_torch_cuda_kernels.py``, which needs a card.
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


def _inputs(shape, dtype, regime="normal", seed=0):
    """The same values for both frameworks, rounded from float32 by each."""
    rng = np.random.default_rng(seed)
    if regime == "zeros":
        x = np.zeros(shape, np.float32)
    elif regime == "ties":
        x = rng.choice(np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32),
                       size=shape)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, dtype=jd), torch.from_numpy(x).to(td)


def _np(a):
    """float32 numpy view of a JAX array or tensor (exact for bf16/f16)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a).astype(np.float32)


def _words(bitmap):
    return bitmap.numpy().view(np.uint32)


def _assert_same_encoding(t_enc, j_enc):
    tv, tm = t_enc
    jv, jm = j_enc
    assert tuple(tv.shape) == tuple(jv.shape)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(_words(tm), np.asarray(jm))
    # bit patterns too: -0.0 and 0.0 must not be confused
    np.testing.assert_array_equal(
        tv.to(torch.float32).view(torch.int32).numpy(),
        np.asarray(jv).astype(np.float32).view(np.int32))


CASES = [((64,), 1, "normal"), ((4096,), 7, "normal"),
         ((5000,), 40, "normal"), ((32, 257), 512, "normal"),
         ((8, 128, 17), 3, "normal"), ((3000,), 9, "ties"),
         ((1000,), 5, "zeros"), ((700,), 600, "normal")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kpb,regime", CASES)
def test_encode_decode_match_jax_plain(shape, kpb, regime, dtype):
    xj, xt = _inputs(shape, dtype, regime, seed=len(shape) * 31 + kpb)
    t_enc = tref.encode_topk_ref(xt, kpb, block=BLOCK)
    _assert_same_encoding(t_enc, jref.encode_topk_ref(xj, kpb, block=BLOCK))
    dense_t = tref.decode_topk_ref(*t_enc, shape)
    dense_j = jref.decode_topk_ref(*jref.encode_topk_ref(xj, kpb, block=BLOCK),
                                   shape)
    assert dense_t.dtype == xt.dtype and tuple(dense_t.shape) == shape
    np.testing.assert_array_equal(_np(dense_t), _np(dense_j))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kpb,regime",
                         [((5000,), 40, "normal"), ((3000,), 9, "ties"),
                          ((64,), 1, "zeros"), ((700,), 600, "normal")])
def test_encode_decode_match_pallas_interpret(shape, kpb, regime, dtype):
    xj, xt = _inputs(shape, dtype, regime, seed=kpb)
    t_enc = ttk.encode_topk(xt, kpb, block=BLOCK)     # CPU: plain version
    j_enc = jtk.encode_topk(xj, kpb, block=BLOCK, interpret=True)
    _assert_same_encoding(t_enc, j_enc)
    np.testing.assert_array_equal(
        _np(ttk.decode_topk(*t_enc, shape)),
        _np(jtk.decode_topk(*j_enc, shape, interpret=True)))


def test_block_default_and_k_of_one_and_full():
    xj, xt = _inputs((9000,), "float32", seed=5)
    for kpb in (1, 4096, 10_000):
        _assert_same_encoding(tref.encode_topk_ref(xt, kpb),
                              jref.encode_topk_ref(xj, kpb))


def test_negative_zero_has_zero_magnitude():
    x = torch.tensor([-0.0, 0.0, -0.0, 1.0] + [0.0] * 28, dtype=torch.float32)
    v, m = tref.encode_topk_ref(x, 4, block=32)
    assert _np(v)[0].tolist() == [-0.0, 0.0, -0.0, 1.0]
    assert _words(m)[0].tolist() == [0b1111]
    np.testing.assert_array_equal(
        tref.decode_topk_ref(v, m, (32,)).view(torch.int32).numpy()[:4],
        x.view(torch.int32).numpy()[:4])


def test_pack_unpack_words_are_lsb_first():
    rng = np.random.default_rng(1)
    keep = rng.random((3, 128)) < 0.5
    keep[0, 31] = keep[1, 0] = True            # sign bit and bit 0
    words = tref.pack_mask_ref(torch.from_numpy(keep))
    np.testing.assert_array_equal(
        _words(words), np.asarray(jref.pack_mask_ref(jnp.asarray(keep))))
    np.testing.assert_array_equal(tref.unpack_mask_ref(words).numpy(), keep)


def test_keep_capped_matches_stable_sort():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-3, 4, size=(4, 256)).astype(np.float32))
    bits = tref._mag_bits(x)
    for k in (1, 17, 200, 256):
        keep = tref._keep_capped(bits, k)
        order = torch.sort(bits, dim=1, descending=True, stable=True).indices
        want = torch.zeros_like(keep)
        want.scatter_(1, order[:, :k], True)
        assert torch.equal(keep, want)
        assert (keep.sum(1) == k).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_codec_topk_mask_matches_jax_xla_mode(dtype):
    xj, xt = _inputs((6, 1000), dtype, seed=11)
    for k in (1, 60, 6000):
        got = tops.codec_topk_mask(xt, k, mode="plain", block=BLOCK)
        want = jops.codec_topk_mask(xj, k, mode="xla", block=BLOCK)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_global_topk_mask_matches_jax(dtype):
    for regime in ("normal", "ties"):
        xj, xt = _inputs((40, 50), dtype, regime, seed=4)
        for k in (1, 20, 2000):
            np.testing.assert_array_equal(
                _np(tcomp.topk_mask(xt, k, use_kernel=False)),
                _np(jcomp.topk_mask(xj, k, use_kernel=False)))
            np.testing.assert_array_equal(_np(tref.topk_mask_ref(xt, k)),
                                          _np(jref.topk_mask_ref(xj, k)))


def test_per_block_k_matches_jax():
    for n in (1, 511, 512, 4096, 4097, 1_638_400, 8 * 128 * 50432):
        for k in (1, 7, 16_384, n):
            assert tops.per_block_k(n, k) == jops.per_block_k(n, k)
            assert tops.per_block_k(n, k, 512) == jops.per_block_k(n, k, 512)


def test_policy_follows_device():
    cpu = torch.device("cpu")
    for off in (False, None, "off"):
        assert tops.resolve_policy(off, cpu) == "global"
    assert tops.resolve_policy("auto", cpu) == "plain"
    assert tops.resolve_policy("auto", torch.device("cuda")) == "cuda"
    assert tops.resolve_policy("force", torch.device("cuda")) == "cuda"
    for force in (True, "force"):
        with pytest.raises(ValueError, match="CUDA"):
            tops.resolve_policy(force, cpu)
    with pytest.raises(ValueError, match="unknown"):
        tops.resolve_policy("fast", cpu)
    x = torch.ones(100)
    with pytest.raises(ValueError):
        tcomp.topk_mask(x, 10, use_kernel="force")


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    ttk.reset_launch_counts()
    _, xt = _inputs((5000,), "float32", seed=3)
    v, m = ttk.encode_topk(xt, 5, block=BLOCK)
    rv, rm = tref.encode_topk_ref(xt, 5, block=BLOCK)
    assert torch.equal(v, rv) and torch.equal(m, rm)
    ttk.decode_topk(v, m, (5000,))
    assert ttk.encode_topk.launches == 0 and ttk.decode_topk.launches == 0


def test_unsupported_dtype_and_block_raise():
    with pytest.raises(TypeError):
        ttk.encode_topk(torch.ones(64, dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        ttk.encode_topk(torch.ones(64), 4, block=48)
