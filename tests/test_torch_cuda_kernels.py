"""The CUDA Top-K kernels (wire codec, error-feedback encode, dense masks)
against their plain PyTorch versions, bit for bit, on the card.  Every test here is marked ``cuda`` and skips without
a CUDA device; the module imports no JAX, so it runs on a machine with the
card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import topk_compress as tk  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# Each case runs at blocks of 512 and 4096, so k = 511 and 4095 are B - 1
# at one of them and k = 4095 and 4096 are B (k is clamped to B).
CASES = [((64,), 1, "normal"), ((4096,), 7, "normal"),
         ((5000,), 40, "normal"), ((32, 257), 512, "normal"),
         ((8, 128, 17), 3, "normal"), ((3000,), 9, "ties"),
         ((1000,), 5, "zeros"), ((700,), 600, "normal"),
         ((8, 128, 1600), 41, "normal"), ((4103,), 41, "normal"),
         ((5003,), 17, "offset"), ((8, 128, 1600), 41, "offset"),
         ((8192,), 41, "ulp"), ((4100,), 2000, "ulp")]
CASES += [((4096,), k, regime) for regime in ("equal", "zeros")
          for k in (1, 511, 4095, 4096)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _input(shape, dtype, regime, seed):
    """A CPU tensor; see ``_on`` for the "offset" regime."""
    gen = torch.Generator().manual_seed(seed)
    n = math.prod(shape)
    sign = torch.randint(0, 2, (n,), generator=gen) * 2.0 - 1.0
    if regime == "zeros":
        x = torch.zeros(n)
    elif regime == "ties":
        x = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])[
            torch.randint(0, 5, (n,), generator=gen)]
    elif regime == "equal":
        x = 0.75 * sign
    elif regime == "ulp":
        # 1 + i ulp: magnitudes that share their top 11-20 bits, so the
        # whole block is one candidate list of the selection
        span = {torch.float32: 4096, torch.bfloat16: 16,
                torch.float16: 128}[dtype]
        x = sign * (1 + (torch.randperm(n, generator=gen) % span)
                    * torch.finfo(dtype).eps)
    else:
        x = torch.randn(n, generator=gen)
    return x.reshape(shape).to(dtype)


def _on(x, device, regime):
    """``x`` on the card; for "offset", a view at storage offset 1 (its
    address is not 16-byte aligned)."""
    if regime != "offset":
        return x.to(device)
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)]).to(device)
    return flat[1:].reshape(x.shape)


def _bits(t):
    return t.cpu().to(torch.float32).view(torch.int32)


def _assert_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            assert torch.equal(_bits(a), _bits(b))
        else:
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kpb,regime", CASES)
def test_cuda_kernels_bit_exact(cuda_device, shape, kpb, regime, dtype):
    x = _input(shape, dtype, regime, seed=kpb)
    xd = _on(x, cuda_device, regime)
    assert (xd.data_ptr() % 16 != 0) == (regime == "offset")
    for block in (512, tk.DEFAULT_BLOCK):
        v, m = tk.encode_topk(xd, kpb, block=block)
        dense = tk.decode_topk(v, m, shape)
        torch.cuda.synchronize()
        vr, mr = ref.encode_topk_ref(x, kpb, block=block)
        assert torch.equal(_bits(v), _bits(vr))
        assert torch.equal(m.cpu(), mr)
        assert torch.equal(_bits(dense), _bits(ref.decode_topk_ref(vr, mr,
                                                                   shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kpb,regime", CASES)
def test_cuda_ef_and_dense_kernels_bit_exact(cuda_device, shape, kpb, regime,
                                             dtype):
    """The residual is drawn like x; inputs are finite (the dense EF
    kernel's ``c - sent`` and the EF encode's ``kept ? 0 : c`` agree only
    there)."""
    x = _input(shape, dtype, regime, seed=kpb)
    r = _input(shape, dtype, regime, seed=kpb + 1000)
    xd, rd = _on(x, cuda_device, regime), _on(r, cuda_device, regime)
    for block in (512, tk.DEFAULT_BLOCK):
        got = [tk.ef_encode_topk(xd, rd, kpb, block=block),
               (tk.blockwise_topk_mask(xd, kpb, block=block),),
               tk.ef_topk(xd, rd, kpb, block=block)]
        torch.cuda.synchronize()
        want = [ref.ef_encode_topk_ref(x, r, kpb, block=block),
                (ref.blockwise_topk_mask_ref(x, kpb, block=block),),
                ref.ef_topk_ref(x, r, kpb, block=block)]
        for g, w in zip(got, want):
            _assert_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,kpb,block", [(5000, 40, 512), (9000, 41, 4096)])
def test_cuda_decode_clamps_overfull_bitmaps(cuda_device, n, kpb, block,
                                             dtype):
    """A bitmap with more than k bits set: slots past k - 1 read the last
    value, as the plain version clamps them."""
    gen = torch.Generator().manual_seed(n)
    nb = -(-n // block)
    values = torch.randn(nb, kpb, generator=gen).to(dtype)
    bitmap = torch.randint(-2 ** 31, 2 ** 31, (nb, block // 32),
                           generator=gen, dtype=torch.int32)
    dense = tk.decode_topk(values.to(cuda_device), bitmap.to(cuda_device),
                           (n,))
    torch.cuda.synchronize()
    assert torch.equal(_bits(dense), _bits(ref.decode_topk_ref(values, bitmap,
                                                              (n,))))


@pytest.mark.cuda
def test_cuda_residual_must_match_x(cuda_device):
    x = torch.randn(4096, device=cuda_device)
    for bad in (torch.zeros(4096, device=cuda_device, dtype=torch.bfloat16),
                torch.zeros(4095, device=cuda_device), torch.zeros(4096)):
        with pytest.raises(ValueError, match="residual"):
            tk.ef_encode_topk(x, bad, 41)
        with pytest.raises(ValueError, match="residual"):
            tk.ef_topk(x, bad, 41)


@pytest.mark.cuda
def test_cuda_policy_launches_and_counts(cuda_device):
    tk.reset_launch_counts()
    x = torch.randn(8, 128, 1600, device=cuda_device)
    y = ops.codec_topk_mask(x, x.numel() // 100, mode=ops.resolve_policy(
        "auto", x.device))
    assert tk.encode_topk.launches == 1 and tk.decode_topk.launches == 1
    assert int((y != 0).sum()) == 400 * 41
    sent, newr = ops.codec_ef_topk(x, torch.zeros_like(x), x.numel() // 100,
                                   mode="cuda")
    assert tk.ef_encode_topk.launches == 1 and tk.decode_topk.launches == 2
    assert tk.encode_topk.launches == 1
    assert torch.equal(sent, y) and torch.equal(newr, x - y)
    ops.topk_mask(x, x.numel() // 100)
    ops.ef_topk(x, newr, 41)
    assert tk.blockwise_topk_mask.launches == 1 and tk.ef_topk.launches == 1
