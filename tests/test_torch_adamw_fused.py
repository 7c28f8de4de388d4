"""AdamW's fused update (``repro_torch.kernels.adamw``): the plain version
and the optimizer's routes against the JAX package's formula written out,
bit for bit, on the CPU; the launch planner; the counters; and, marked
``cuda``, the kernel against the plain version on the card.  The module
imports no JAX, so the card's tests run on a machine with the card and no
JAX:

    python -m pytest -q -m cuda tests/test_torch_adamw_fused.py
"""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw as fa  # noqa: E402
from repro_torch.optim import adamw, linear_warmup_cosine  # noqa: E402

# leaf sizes the cells' trees hold (gpt2-xl's 1,600-wide norms, its padded
# vocabulary's table, nemo's 131k x 5120 embedding past 2^31 bytes) and
# sizes that are not multiples of 4
GPT2 = [50432 * 1600, 1024 * 1600] + [1600, 1600, 1600 * 1600, 1600 * 1600,
                                      1600 * 1600, 1600 * 1600, 1600, 1600,
                                      1600 * 6400, 6400 * 1600] * 48 \
    + [1600, 1600, 1600 * 50432]
NEMO = [131072 * 5120] + [5120, 5120 * 4096, 5120 * 1024, 5120 * 1024,
                          4096 * 5120, 5120, 5120 * 14336, 14336 * 5120,
                          5120 * 14336] * 6 + [5120, 5120 * 131072]


def _tree(seed, shapes=(("a", (3, 5)), ("b", (7,)), ("c", (2, 3, 4)),
                        ("d", (1,)))):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen) for k, s in shapes}


def _reference(p, g, m, v, lr, bc1, bc2, b1, b2, eps, wd):
    """The JAX package's AdamW step, written out (``optax``-style order)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return p - lr * (upd + wd * p), m, v


@pytest.mark.parametrize("consume", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_update_on_the_cpu_equals_the_written_out_formula(weight_decay,
                                                          consume):
    """Three warm-up steps (learning rate and both corrections move): the
    update's parameters and moments equal the formula written out bit for
    bit; with ``consume_grads`` the new parameters sit in the gradients'
    memory and the new moments in the old moments', without it every
    input is as it was."""
    b1, b2, eps = 0.9, 0.95, 1e-8
    sched = linear_warmup_cosine(1e-2, 2, 3)
    opt = adamw(sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    p = _tree(0)
    st = opt.init(p)
    want_p, want_m, want_v = dict(p), dict(st.inner["m"]), dict(st.inner["v"])
    for step in range(3):
        g = _tree(step + 1)
        t = torch.tensor(step + 1, dtype=torch.float32)
        lr = sched(torch.tensor(step))
        bc1, bc2 = 1 - torch.tensor(b1) ** t, 1 - torch.tensor(b2) ** t
        for k in p:
            want_p[k], want_m[k], want_v[k] = _reference(
                want_p[k], g[k], want_m[k], want_v[k], lr, bc1, bc2, b1, b2,
                eps, weight_decay)
        inputs = [x.clone() for tree in (p, g, st.inner["m"], st.inner["v"])
                  for x in tree.values()]
        g_ptr = {k: x.data_ptr() for k, x in g.items()}
        m_ptr = {k: x.data_ptr() for k, x in st.inner["m"].items()}
        v_ptr = {k: x.data_ptr() for k, x in st.inner["v"].items()}
        new_p, new_st = opt.update(g, st, p, consume_grads=consume)
        if consume:
            assert {k: x.data_ptr() for k, x in new_p.items()} == g_ptr
            assert {k: x.data_ptr() for k, x in new_st.inner["m"].items()} \
                == m_ptr
            assert {k: x.data_ptr() for k, x in new_st.inner["v"].items()} \
                == v_ptr
        else:
            after = [x for tree in (p, g, st.inner["m"], st.inner["v"])
                     for x in tree.values()]
            assert all(torch.equal(a, b) for a, b in zip(after, inputs))
            assert not set(g_ptr.values()) & {
                x.data_ptr() for x in new_p.values()}
        for k in p:
            assert torch.equal(new_p[k], want_p[k])
            assert torch.equal(new_st.inner["m"][k], want_m[k])
            assert torch.equal(new_st.inner["v"][k], want_v[k])
        p, st = new_p, new_st


@pytest.mark.parametrize("in_place", [False, True])
def test_plain_equals_written_out(in_place):
    """The plain version (the kernel's op-for-op reference) and the
    written-out formula give the same fp32 numbers, from a state past its
    first step."""
    h = fa.Hyper(lr=torch.tensor(3e-3), b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, bc1=1 - torch.tensor(0.9) ** 3,
                 bc2=1 - torch.tensor(0.95) ** 3)
    p, g, m = (torch.randn(1001, generator=torch.Generator().manual_seed(s))
               for s in range(3))
    v = torch.rand(1001, generator=torch.Generator().manual_seed(3))
    want = fa.written_out(p, g, m, v, h)
    got = fa.plain(p, g.clone(), m.clone(), v.clone(), h, in_place)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _block_span(launch, sizes, block):
    """(leaf position, first element, end) that block ``block`` of
    ``launch`` updates, found as ``adamw_kernel`` finds it: the last leaf
    whose first chunk is at most ``block``, then 64-bit offsets."""
    lo, hi = 0, len(launch.leaves) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if launch.chunk0[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    start = (block - launch.chunk0[lo]) * fa.CHUNK
    leaf = launch.leaves[lo]
    return leaf, start, min(start + fa.CHUNK, sizes[leaf])


def _assert_covers(sizes):
    launches = fa.plan_launches(sizes)
    cap = fa.CAPACITY
    live = [i for i, n in enumerate(sizes) if n]
    assert [i for ln in launches for i in ln.leaves] == live
    assert len(launches) == -(-len(live) // cap)
    spans = {i: [] for i in live}
    for ln in launches:
        assert 1 <= len(ln.leaves) <= cap
        assert ln.chunk0[0] == 0 and len(ln.chunk0) == len(ln.leaves) + 1
        for block in range(ln.chunk0[-1]):
            leaf, start, end = _block_span(ln, sizes, block)
            assert start < end
            spans[leaf].append((start, end))
    for i in live:          # each element of each leaf exactly once
        got = sorted(spans[i])
        assert got[0][0] == 0 and got[-1][1] == sizes[i]
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    return launches


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("count", [1, 15, 57, 485, 700, 672, 673, 1345])
def test_launch_plan_covers_every_element_once(count, empty):
    """Leaf counts of one leaf, the gspmd cell (15), nemo (57), gpt2-xl
    fusion (485), a full launch (672) and more than a launch carries (673,
    700, 1345); sizes not multiples of 4, blocks that cut a leaf at chunk
    boundaries and, with ``empty``, zero-sized leaves, which are in no
    launch."""
    gen = torch.Generator().manual_seed(count)
    sizes = torch.randint(1, 3 * fa.CHUNK + 7, (count,),
                          generator=gen).tolist()
    sizes[0] = 1601
    if count > 2:
        sizes[2] = fa.CHUNK
        if empty:
            sizes[1] = sizes[-1] = 0
    launches = _assert_covers(sizes)
    live = sum(map(bool, sizes))
    assert len(launches) == -(-live // fa.CAPACITY)


@pytest.mark.parametrize("sizes", [GPT2, NEMO], ids=["gpt2xl", "nemo"])
def test_launch_plan_of_the_cells_leaves(sizes):
    """gpt2-xl fusion's 485 leaves are one launch, and nemo's 57, its
    671M-element embedding and head cut into 40,960 blocks each."""
    assert len(_assert_covers(sizes)) == 1
    ln = fa.plan_launches(sizes)[0]
    assert ln.chunk0[1] == -(-sizes[0] // fa.CHUNK)


def test_binding_matches_the_c_prototype():
    """ctypes cannot see a binding that disagrees with its C prototype (a
    pointer cut to 32 bits, arguments shifted), so ``SIGNATURE`` is held
    against ``adamw_step``'s prototype, parsed from the source."""
    args = re.search(r"int adamw_step\(([^)]*)\)",
                     fa._SOURCE.read_text()).group(1).split(",")
    assert len(args) == 7
    assert list(fa.SIGNATURE) == [
        ctypes.c_void_p if "*" in a else ctypes.c_int for a in args]


def test_counters_and_routes_on_the_cpu():
    """fp32 CPU leaves take the plain version, a bfloat16 leaf the
    written-out formula; both count as written out, none as fused, and no
    launch is made."""
    opt = adamw(1e-3)
    p = {"w": torch.randn(4, 3), "h": torch.randn(5).to(torch.bfloat16)}
    g = {"w": torch.randn(4, 3), "h": torch.randn(5).to(torch.bfloat16)}
    fa.reset_counts()
    new_p, _ = opt.update(g, opt.init(p), p, consume_grads=True)
    u = fa.update
    assert (u.launches, u.fused_leaves, u.fused_params) == (0, 0, 0)
    assert (u.written_leaves, u.written_params) == (2, 17)
    assert new_p["h"].dtype == torch.bfloat16
    assert new_p["w"].data_ptr() == g["w"].data_ptr()
    fa.reset_counts()
    assert u.written_leaves == 0


# ------------------------------------------------------------- the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# gpt2-xl's and nemo's leaf shapes, a ragged leaf, and nemo's embedding
CARD_SHAPES = [(50432, 1600), (1024, 1600), (1600,), (1600, 6400),
               (48, 1600, 1600), (1601,), (3,), (5120, 4096), (14336, 5120),
               (131072, 5120)]


def _card_state(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i, shape in enumerate(CARD_SHAPES):
        p = torch.randn(shape, device=dev, generator=gen)
        if i == 5:          # storage offset 1: not 16-byte aligned
            p = torch.cat([p.new_zeros(1), p])[1:]
        out.append([p, torch.zeros_like(p), torch.zeros_like(p)])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("in_place", [True, False])
def test_kernel_equals_the_plain_version_on_the_card(cuda_device, in_place,
                                                     weight_decay):
    """Three warm-up steps over the cells' leaf shapes (one unaligned, one
    ragged, one past 2^31 bytes): the kernel's parameters and moments equal
    the plain version's with ``torch.equal``; in place they sit in the
    gradients' and moments' memory, out of place every input is as it was;
    one launch a step."""
    dev = cuda_device
    b1, b2, eps = 0.9, 0.95, 1e-8
    sched = linear_warmup_cosine(1e-2, 2, 3)
    kern = _card_state(dev, 0)
    plain = [[t.clone() for t in leaf] for leaf in kern]
    gen = torch.Generator(device=dev).manual_seed(1)
    fa.reset_counts()
    for step in range(3):
        t = torch.tensor(step + 1, dtype=torch.float32)
        h = fa.Hyper(lr=sched(torch.tensor(step)), b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay,
                     bc1=1 - torch.tensor(b1) ** t,
                     bc2=1 - torch.tensor(b2) ** t)
        grads = [torch.randn(p.shape, device=dev, generator=gen) * 1e-2
                 for p, _, _ in kern]
        grads[5] = torch.cat([grads[5].new_zeros(1), grads[5]])[1:]
        ref_grads = [g.clone() for g in grads] if in_place else grads
        leaves = [(p, g, m, v) for (p, m, v), g in zip(kern, grads)]
        ptrs = [(g.data_ptr(), m.data_ptr(), v.data_ptr())
                for _, g, m, v in leaves]
        got = fa.update(leaves, h, in_place)
        torch.cuda.synchronize(dev)
        for i, ((p, m, v), g) in enumerate(zip(plain, ref_grads)):
            if not in_place:        # the kernel left its inputs as they were
                assert torch.equal(kern[i][0], p)
                assert torch.equal(kern[i][1], m)
                assert torch.equal(kern[i][2], v)
                assert torch.equal(grads[i], g)
            want = fa.plain(p, g, m, v, h, in_place)
            for a, b in zip(got[i], want):
                assert torch.equal(a, b)
            if in_place:
                assert tuple(x.data_ptr() for x in got[i]) == ptrs[i]
            plain[i] = list(want)
            kern[i] = list(got[i])
            del want
        del got, leaves, grads, ref_grads
        torch.cuda.synchronize(dev)
    assert fa.update.launches == 3
    assert fa.update.fused_leaves == 3 * len(CARD_SHAPES)
    assert fa.update.written_leaves == 0
