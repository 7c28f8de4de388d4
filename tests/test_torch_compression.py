"""The port's compression arithmetic and boundary ops against the JAX
package's.  Byte models, break-even and Eq. 7 ratios are framework-free and
must be equal to the last bit; the tensor ops are compared on the same
numpy inputs."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as J  # noqa: E402
from repro_torch.core import compression as T  # noqa: E402


@pytest.mark.parametrize("encoding", ["paper", "mask", "none"])
def test_wire_bytes_and_break_even_exact(encoding):
    for numel, ratio, itemsize in itertools.product(
            [1, 7, 4096, 1_638_400, 6_455_296], [0.5, 1.0, 1.0001, 2.9, 3.0,
                                                  3.5, 10, 100, 300, 1e6],
            [2, 4]):
        assert T.wire_bytes(numel, ratio, encoding, itemsize) == \
            J.wire_bytes(numel, ratio, encoding, itemsize)
    for itemsize in (1, 2, 4, 8):
        assert T.encoding_break_even(encoding, itemsize) == \
            J.encoding_break_even(encoding, itemsize)


def test_ratio_to_k_exact():
    for numel, ratio in itertools.product([1, 3, 100, 4097, 1_638_400],
                                          [0.1, 1.0, 1.5, 3.0, 100, 1e9]):
        assert T.ratio_to_k(numel, ratio) == J.ratio_to_k(numel, ratio)


def test_adaptive_ratios_exact():
    rng = np.random.default_rng(0)
    cases = [([86.11349131554826], 1.0, 3.0, None),
             ([0.0, 0.0], 100.0, 3.0, None),
             ([], 100.0, 3.0, None)]
    for _ in range(40):
        n = int(rng.integers(1, 30))
        times = list(rng.exponential(size=n) * 10 ** rng.uniform(-4, 2))
        oh = list(rng.choice([3.0, 5.0, 1.0322580645161290], size=n))
        cases.append((times, float(rng.choice([1.0, 2.0, 10.0, 100.0])),
                      oh, oh if rng.random() < 0.5 else None))
    for times, r, oh, be in cases:
        assert T.adaptive_ratios(times, r, oh, be) == \
            J.adaptive_ratios(times, r, oh, be)


def test_topk_select_and_decode_match_jax():
    rng = np.random.default_rng(1)
    x = rng.choice(np.array([-2.0, -1.0, 0.5, 1.0, 3.0], np.float32),
                   size=(7, 11))                      # many ties
    for k in (1, 5, 30, 77, 100):
        tv, ti = T.topk_select(torch.from_numpy(x), k)
        jv, ji = J.topk_select(jnp.asarray(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            T.topk_decode(tv, ti, x.shape).numpy(),
            np.asarray(J.topk_decode(jv, ji, x.shape)))
    assert T.topk_decode(tv.to(torch.bfloat16), ti, x.shape).dtype == \
        torch.bfloat16


def test_boundary_compress_sparsifies_both_directions():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    g = rng.standard_normal((4, 300)).astype(np.float32)
    for policy, jpolicy in ((False, False), ("auto", "auto")):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = T.boundary_compress(xt, 12, 30, policy)
        (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
        jy, vjp = jax.vjp(lambda a: J.boundary_compress(a, 12, 30, jpolicy),
                          jnp.asarray(x))
        (jgx,) = vjp(jnp.asarray(g))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    assert int((T.compress_for_edge(torch.from_numpy(x), 100.0) != 0).sum()) \
        == 12
    assert T.compress_for_edge(torch.from_numpy(x), 1.0) is not None


@pytest.mark.parametrize("policy", [False, "auto"])
def test_ef_compress_matches_jax(policy):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(3000).astype(np.float32)
    st = T.ErrorFeedbackState.init(torch.from_numpy(x))
    js = J.ErrorFeedbackState.init(jnp.asarray(x))
    for step in range(3):
        xs = x * (step + 1)
        sent, st = T.ef_compress(torch.from_numpy(xs), st, 50, policy)
        jsent, js = J.ef_compress(jnp.asarray(xs), js, 50, policy)
        np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
        np.testing.assert_allclose(st.residual.numpy(),
                                   np.asarray(js.residual), rtol=0, atol=1e-6)


def test_ef_codec_cuda_mode_on_a_cpu_tensor_raises():
    from repro_torch.kernels import ops
    x = torch.ones(64)
    with pytest.raises(ValueError, match="mode 'cuda'"):
        ops.codec_ef_topk(x, torch.zeros(64), 4, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        T.ef_compress(x, T.ErrorFeedbackState.init(x), 4, "force")


def test_dense_payload_bytes():
    assert T.dense_payload_bytes(torch.zeros(3, 5)) == J.dense_payload_bytes(
        jnp.zeros((3, 5)))
    assert T.dense_payload_bytes(torch.zeros(7, dtype=torch.bfloat16)) == 14.0
