"""The GPipe pipeline with one stage a rank (``make_pipeline_train_fn`` on
a process mesh: 4 gloo ranks on the host-staged group) against the JAX
package's ``shard_map`` pipeline on 4 devices, on the CPU.

gpt2-smoke cut to 8 layers, batch 8 × 32 in 4 micro-batches; the weights
are the port's ``init`` at seed 0 (and a tied-embedding variant's) and the
batch comes from ``numpy.random.default_rng(1)``, both made here and
handed to the two sides as numpy arrays.  JAX runs in a subprocess with 4
forced host devices and Auto mesh axes, its gradients under
``jax.set_mesh``, beside one spawn of the port's 4 ranks
(``torch_spmd_ranks.run_pipeline_ranks``).  The cases
(``torch_spmd_ranks.PIPE_CASES``): the ``(4,)`` model mesh; the ``(2, 2)``
pod × model mesh at base ratios 1 and 10 (the pod edge 1 -> 2 at 3r), each
with the global Top-K and with the codec (``"auto"``); the ``(2, 2)`` data
× model mesh (two replicas of a 2-stage pipeline); a tied-embedding
variant on the pod mesh.  JAX also runs the 2-stage pipeline alone on a
``(2,)`` mesh, which shows that its gradient on the data × model mesh is
the single pipeline's.

Tolerances, as ``test_torch_pipeline`` holds the single-process
pipeline: each rank's loss within rel 1e-6 of JAX's uncompressed and rtol
1e-5 compressed; each rank's gradient shards leaf by leaf within 1e-5 of
the JAX leaf's max |value|, and the gradient assembled from the ranks'
shards within rel 1e-5 as one vector; the AdamW step-1 parameters as
``test_torch_gspmd`` holds AdamW (at most 1e-4 of the entries off atol
1e-6 + rtol 1e-4, none off by 2 × lr).  Against the port's single-process
pipeline on a mesh of CPU positions: loss and gradients within rel 1e-6.
The slow edge's decoded tensor and gradient equal ``boundary_compress``'s
forward and backward bit for bit, and each message on it has the wire's
bytes.
"""
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import to_numpy_tree  # noqa: E402
from repro_torch.core.compression import (boundary_compress,  # noqa: E402
                                          ratio_to_k)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models import causal_lm  # noqa: E402
import torch_spmd_ranks as ranks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = ranks.PIPE_CASES
COMPRESSED = [n for n, c in CASES.items() if "pod" in c[1]]
LOSS_RTOL = 1e-6                # uncompressed, as test_torch_pipeline
COMPRESSED_LOSS_RTOL = 1e-5
GRAD_REL = 1e-5                 # leaf by leaf of max |JAX|, and one vector
SINGLE_RTOL = 1e-6              # the port's single-process pipeline
ADAMW_ATOL, ADAMW_RTOL = 1e-6, 1e-4
TIMEOUT = 240

SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import resolve
from repro.distributed.pipeline import make_pipeline_train_fn, microbatch
from repro.optim import adamw

CASES, N_MICRO, LR, LAYERS, SEQ = {cases!r}, {micro}, {lr}, {layers}, {seq}
z = np.load(sys.argv[1])
out = {{}}
{helpers}

def flat(prefix, t):
    for path, leaf in jax.tree_util.tree_leaves_with_path(t):
        out[prefix + pstr(path)] = np.asarray(leaf)

cfg = resolve("gpt2-xl").smoke.replace(n_layers=LAYERS, max_seq=SEQ)
mb = microbatch({{k: z[k] for k in ("tokens", "labels")}}, N_MICRO)
params = {{False: tree("w/"), True: tree("wt/")}}
# the 2-stage pipeline alone: what the data x model mesh replicates
CASES = dict(CASES, model2=((2,), ("model",), 1.0, False, False))
for name, (shape, axes, ratio, kern, tied) in CASES.items():
    c = cfg.replace(tie_embeddings=True) if tied else cfg
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,)
                         * len(shape), devices=jax.devices()[:n])
    fn = make_pipeline_train_fn(c, mesh, N_MICRO, ratio, use_kernel=kern)
    with jax.set_mesh(mesh):
        loss, g = jax.value_and_grad(lambda p: fn(p, mb))(params[tied])
    out[f"{{name}}/loss"] = np.asarray(loss)
    flat(f"{{name}}/grad/", g)
    # make_pipeline_train_step's update, on the same gradients
    g = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(np.asarray(a)),
                               g)
    opt = adamw(LR)
    new, _ = opt.update(g, opt.init(params[tied]), params[tied])
    flat(f"{{name}}/new/", new)
np.savez(sys.argv[2], **out)
"""



def _tree(z, prefix):
    tree = {}
    for key in z.files:
        if key.startswith(prefix):
            *parts, last = key[len(prefix):].split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = z[key]
    return tree


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 512, (ranks.PIPE_BATCH, ranks.PIPE_SEQ))
             .astype(np.int32) for k in ("tokens", "labels")}
    params = {tied: to_numpy_tree(causal_lm.init(
        ranks.pipeline_cfg(tied), torch.Generator().manual_seed(0)))
              for tied in (False, True)}
    return {"params": params, "batch": batch}


@pytest.fixture(scope="module")
def both(run, tmp_path_factory):
    """(JAX's results, the port's ranks' results)."""
    tmp = tmp_path_factory.mktemp("spmd_pipeline")
    arrays = dict(run["batch"])
    for tied, prefix in ((False, "w/"), (True, "wt/")):
        ranks.flat_arrays(run["params"][tied], prefix, arrays)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = SCRIPT.format(
        cases=CASES, micro=ranks.PIPE_MICRO, lr=ranks.PIPE_LR,
        layers=ranks.PIPE_LAYERS, seq=ranks.PIPE_SEQ,
        helpers=ranks.JAX_HELPERS)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(ranks.run_pipeline_ranks, 4, rdv_dir=str(tmp),
                        device="cpu", backend=spmd.STAGED, timeout=TIMEOUT,
                        args=(run,))
        assert jax_proc.wait(timeout=TIMEOUT) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


def _stage(case, coordinate):
    shape, axes = CASES[case][:2]
    stage_axes = [a for a in axes if a != "data"]
    return int(np.ravel_multi_index(
        [coordinate[a] for a in stage_axes],
        [shape[axes.index(a)] for a in stage_axes]))


def _index(got):
    return tuple(slice(o, o + n) for o, n in zip(got["offset"], got["shape"]))


def _whole(port, case, kind):
    """The gradients (``kind`` "grads") or the new parameters ("new") as
    whole leaves, each filled in from the shards the ranks hold."""
    out = {}
    for key in port[0]["cases"][case][kind]:
        shards = [res["cases"][case][kind][key] for res in port]
        shape = np.max([np.add(g["offset"], g["shape"]) for g in shards],
                       axis=0)
        out[key] = np.zeros(shape, dtype=shards[0]["values"].dtype)
        for g in shards:
            out[key][_index(g)] = g["values"]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(both, case):
    """Every rank returns the same loss, JAX's: within rel 1e-6
    uncompressed and rtol 1e-5 with the pod edge compressed."""
    jax_run, port = both
    want = float(jax_run[f"{case}/loss"])
    rtol = COMPRESSED_LOSS_RTOL if case in COMPRESSED else LOSS_RTOL
    losses = {res["cases"][case]["loss"] for res in port}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - want) <= rtol * abs(want)


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_shards_match_jax(both, case):
    """Each rank's gradient shards, by its stage, leaf by leaf within 1e-5
    of the JAX leaf's max |value|, the replicated leaves' the same on
    every rank (summed over the stages); the gradient assembled from them
    within rel 1e-5 as one vector."""
    jax_run, port = both
    for res in port:
        for key, got in res["cases"][case]["grads"].items():
            full = jax_run[f"{case}/grad/{key}"]
            want = full[_index(got)]
            assert got["values"].shape == want.shape, key
            assert np.abs(got["values"] - want).max() <= \
                GRAD_REL * np.abs(full).max(), key
            if not key.startswith("blocks/"):      # the same on every rank
                assert np.array_equal(
                    got["values"],
                    port[0]["cases"][case]["grads"][key]["values"]), key
    whole = _whole(port, case, "grads")
    num = sum(float(((whole[k] - jax_run[f"{case}/grad/{k}"]) ** 2).sum())
              for k in whole)
    den = sum(float((jax_run[f"{case}/grad/{k}"] ** 2).sum()) for k in whole)
    assert math.isfinite(num) and num <= GRAD_REL ** 2 * den


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_are_split_by_stage(both, case):
    """A block leaf's shard on each rank is its stage's ``L / ns`` layers
    (JAX's ``in_specs``); every other leaf is whole on every rank."""
    _, port = both
    shape, axes = CASES[case][:2]
    ns = math.prod(n for a, n in zip(axes, shape) if a != "data")
    per = ranks.PIPE_LAYERS // ns
    for res in port:
        stage = _stage(case, res["cases"][case]["coordinate"])
        for key, got in res["cases"][case]["grads"].items():
            if key.startswith("blocks/"):
                assert got["offset"][0] == stage * per, key
                assert got["shape"][0] == per, key
            else:
                assert not any(got["offset"]), key


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_step_matches_jax(both, case):
    """The parameters after one AdamW step, shard by shard, as
    ``test_torch_gspmd`` holds AdamW against JAX; the replicated leaves
    take the same update on every rank, bit for bit, and the moments are
    placed as the parameters."""
    jax_run, port = both
    for res in port:
        got_case = res["cases"][case]
        assert got_case["moments_placed_as_params"]
        for key, got in got_case["new"].items():
            a, b = got["values"], jax_run[f"{case}/new/{key}"][_index(got)]
            off = np.abs(a - b) > ADAMW_ATOL + ADAMW_RTOL * np.abs(b)
            assert off.sum() <= 1e-4 * off.size, key
            assert np.all(np.abs(a - b) <= 2 * ranks.PIPE_LR), key
            if not key.startswith("blocks/"):
                assert np.array_equal(
                    a, port[0]["cases"][case]["new"][key]["values"]), key
    if "step_equal" in port[0]["cases"][case]:
        assert all(res["cases"][case]["step_equal"] for res in port)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_single_process_pipeline(both, case):
    """The port's own pipeline on a mesh of CPU positions, on rank 0:
    loss and gradients within rel 1e-6."""
    _, port = both
    single = port[0]["cases"][case]["single"]
    assert abs(port[0]["cases"][case]["loss"] - single["loss"]) <= \
        SINGLE_RTOL * abs(single["loss"])
    want = {}
    ranks.flat_arrays(single["grads"], "", want)
    whole = _whole(port, case, "grads")
    assert whole.keys() == want.keys()
    num = sum(float(((whole[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert num <= SINGLE_RTOL ** 2 * den


def test_jax_replica_axis_gradient_is_the_single_pipelines(both):
    """JAX's gradient on the data × model mesh equals its 2-stage pipeline
    alone on a ``(2,)`` mesh: the replicas do not add up their gradients.
    The port is held to the same (the cases above)."""
    jax_run, _ = both
    keys = [k for k in jax_run.files if k.startswith("model2/grad/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(
            jax_run[k.replace("model2/", "data_model/")], jax_run[k])
    assert float(jax_run["data_model/loss"]) == float(jax_run["model2/loss"])


def _edge_k(case):
    ratio = CASES[case][2]
    n = (ranks.PIPE_BATCH // ranks.PIPE_MICRO * ranks.PIPE_SEQ
         * ranks.pipeline_cfg().d_model)
    return n, ratio_to_k(n, 3.0 * ratio)


@pytest.mark.parametrize("case", COMPRESSED)
def test_slow_edge_wire_is_boundary_compress(both, case):
    """On the pod edge 1 -> 2: what rank 2 decodes and trains on is
    ``boundary_compress(y, k, k, use_kernel)`` of rank 1's output, bit for
    bit, for each micro-batch; what rank 1 decodes as its output's
    gradient is that function's backward of the dense gradient rank 2
    encoded."""
    _, port = both
    kern = CASES[case][3]
    _, k = _edge_k(case)
    sender = [t for way, t in port[1]["cases"][case]["wire"]]
    receiver = [t for way, t in port[2]["cases"][case]["wire"]]
    ways_s = [way for way, _ in port[1]["cases"][case]["wire"]]
    ways_r = [way for way, _ in port[2]["cases"][case]["wire"]]
    n = ranks.PIPE_MICRO
    assert ways_s == ["encode"] * n + ["decode"] * n
    assert ways_r == ["decode"] * n + ["encode"] * n
    for m in range(n):
        y = torch.from_numpy(sender[m]).requires_grad_(True)
        sent = boundary_compress(y, k, k, kern)
        assert torch.equal(sent.detach(), torch.from_numpy(receiver[m]))
        # the backward runs micro-batch n - 1 first on both ranks
        g = torch.from_numpy(receiver[n + n - 1 - m])
        back, = torch.autograd.grad(sent, y, g)
        assert torch.equal(back, torch.from_numpy(sender[n + n - 1 - m]))
    assert not any(port[r]["cases"][case]["wire"] for r in (0, 3))


@pytest.mark.parametrize("case", list(CASES))
def test_messages_are_the_wire(both, case):
    """Every message of the call, as the staged group carried it: on the
    pod edge the codec's wire (values and bitmap, one message) or, for
    the global Top-K, the dense masked tensor; elsewhere the dense
    boundary; each edge carries one message a micro-batch each way, the
    tags 2 m (forward) and 2 m + 1 (backward), and the staged counts are
    the messages' bytes."""
    _, port = both
    axes, _, kern = CASES[case][1:4]
    n, k = _edge_k(case)
    dense = n * 4
    (nb, kb), (_, words) = ops.codec_wire_shapes(n, k)
    wire = nb * words * 4 + nb * kb * 4 if kern else dense
    coords = [res["cases"][case]["coordinate"] for res in port]
    for rank, res in enumerate(port):
        got = res["cases"][case]
        stage = _stage(case, coords[rank])
        by_peer = {}
        for kind, peer, tag, nbytes in got["messages"]:
            peer_stage = _stage(case, coords[peer])
            assert abs(peer_stage - stage) == 1
            slow = "pod" in axes and min(stage, peer_stage) == 1
            assert nbytes == (wire if slow else dense), (rank, peer, tag)
            toward_next = (kind == "send") == (tag % 2 == 0)
            assert (peer_stage > stage) == toward_next
            by_peer.setdefault(peer, []).append(tag)
        ns = max(_stage(case, c) for c in coords) + 1
        assert len(by_peer) == (stage > 0) + (stage < ns - 1)
        for tags in by_peer.values():
            assert sorted(tags) == list(range(2 * ranks.PIPE_MICRO))
        for kind in ("send", "recv"):
            assert got["staged"].get(f"{kind}_bytes", 0) == sum(
                b for k2, _, _, b in got["messages"] if k2 == kind)


@pytest.mark.parametrize("case", list(CASES))
def test_argument_bytes_equal_the_shardings(both, case):
    _, port = both
    for res in port:
        got = res["cases"][case]
        assert got["argument_bytes"] == got["argument_bytes_want"]


def test_staged_send_and_recv_carry_a_tensor_by_tag(both):
    _, port = both
    assert port[1]["p2p"]["received"] == [[0.0, 0.25, 0.5, 0.75, 1.0, 1.25],
                                          [7, 8, 9]]
    assert port[0]["p2p"]["staged"] == {"send_calls": 2, "send_bytes": 36}
    assert port[1]["p2p"]["staged"] == {"recv_calls": 2, "recv_bytes": 36}
    assert port[2]["p2p"]["staged"] == {} == port[3]["p2p"]["staged"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b", "xlstm-1_3b",
                                  "seamless-m4t-large-v2", "internvl2-2b"])
def test_non_dense_family_raises_on_a_process_mesh(both, arch):
    _, port = both
    for res in port:
        assert res["refusals"][arch].startswith(
            "NotImplementedError: pipeline path covers the dense family")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,k", [((2, 32, 128), 820), ((3, 5000), 7),
                                     ((4096,), 4096)])
def test_codec_halves_compose_to_codec_topk_mask(dtype, shape, k):
    """``codec_encode`` then ``codec_decode`` is ``codec_topk_mask`` bit for
    bit, and the wire has the shapes ``codec_wire_shapes`` gives."""
    g = torch.Generator().manual_seed(len(shape) + k)
    x = torch.randn(shape, generator=g).to(dtype)
    x.view(-1)[::7] = x.view(-1)[3]                 # ties
    values, bitmap = ops.codec_encode(x, k, "plain")
    vshape, bshape = ops.codec_wire_shapes(x.numel(), k)
    assert tuple(values.shape) == vshape and values.dtype == dtype
    assert tuple(bitmap.shape) == bshape and bitmap.dtype == torch.int32
    got = ops.codec_decode(values, bitmap, x.shape, "plain")
    want = ops.codec_topk_mask(x, k, "plain")
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32
                                else torch.int32),
                       want.view(torch.int16 if dtype != torch.float32
                                 else torch.int32))
    with pytest.raises(ValueError, match="mode 'cuda'"):
        ops.codec_encode(x, k, "cuda")
    with pytest.raises(ValueError, match="mode 'cuda'"):
        ops.codec_decode(values, bitmap, x.shape, "cuda")
