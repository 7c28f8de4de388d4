"""The CUDA wire-codec kernels against their plain PyTorch versions, bit
for bit, on the card.  Every test here is marked ``cuda`` and skips without
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
CASES = [((64,), 1, "normal"), ((4096,), 7, "normal"),
         ((5000,), 40, "normal"), ((32, 257), 512, "normal"),
         ((8, 128, 17), 3, "normal"), ((3000,), 9, "ties"),
         ((1000,), 5, "zeros"), ((700,), 600, "normal"),
         ((8, 128, 1600), 41, "normal")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _input(shape, dtype, regime, seed):
    gen = torch.Generator().manual_seed(seed)
    n = math.prod(shape)
    if regime == "zeros":
        x = torch.zeros(n)
    elif regime == "ties":
        x = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])[
            torch.randint(0, 5, (n,), generator=gen)]
    else:
        x = torch.randn(n, generator=gen)
    return x.reshape(shape).to(dtype)


def _bits(t):
    return t.cpu().to(torch.float32).view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kpb,regime", CASES)
def test_cuda_kernels_bit_exact(cuda_device, shape, kpb, regime, dtype):
    x = _input(shape, dtype, regime, seed=kpb)
    for block in (512, tk.DEFAULT_BLOCK):
        v, m = tk.encode_topk(x.to(cuda_device), kpb, block=block)
        dense = tk.decode_topk(v, m, shape)
        torch.cuda.synchronize()
        vr, mr = ref.encode_topk_ref(x, kpb, block=block)
        assert torch.equal(_bits(v), _bits(vr))
        assert torch.equal(m.cpu(), mr)
        assert torch.equal(_bits(dense), _bits(ref.decode_topk_ref(vr, mr,
                                                                   shape)))


@pytest.mark.cuda
def test_cuda_policy_launches_and_counts(cuda_device):
    tk.reset_launch_counts()
    x = torch.randn(8, 128, 1600, device=cuda_device)
    y = ops.codec_topk_mask(x, x.numel() // 100, mode=ops.resolve_policy(
        "auto", x.device))
    assert tk.encode_topk.launches == 1 and tk.decode_topk.launches == 1
    assert int((y != 0).sum()) == 400 * 41
    with pytest.raises(NotImplementedError, match="ef_encode_topk"):
        ops.codec_ef_topk(x, torch.zeros_like(x), 100, mode="cuda")
