"""What each rank of ``tests/test_torch_spmd.py`` runs (a module of its own,
without JAX, so the spawned ranks import only the port).

``run_ranks`` is called on every rank of a 4-rank process group on the CPU:

* for every placement case, the DTensor that ``distribute_tensor`` makes of
  ``arange`` with the port's placements: its local values, shape and
  offset on this rank;
* ``constrain`` on the ``(2, 2)`` process mesh, and ``make_local_mesh``
  inside the group;
* for each arch, the gspmd train step that ``build_jitted`` builds on the
  ``(2, 2)`` ``("data", "model")`` process mesh, from the JAX run's
  weights and batches, for as many steps as JAX took: the losses and
  ``grad_norm`` a step, and every leaf's local shard (values, shape,
  offset) of the parameters and the optimizer state after the last step;
  rank 0 also runs the port's unsharded step on the whole weights and
  returns its losses and the gathered parameters;
* one AdamW step of gpt2-smoke sharded against the unsharded step.

``run_moe_ranks`` (``tests/test_torch_spmd_moe.py``) takes the MoE
family's train step on the same mesh, under each override set's rules and
parameter overrides, counting the (token, choice) entries the capacity
dispatch drops, and builds every family's steps under every MoE dispatch;
``run_serve_ranks`` (``tests/test_torch_spmd_serve.py``) the sharded
prefill and decode steps.  ``run_case_ranks``
(``tests/test_torch_spmd_moe_ragged.py``, ``test_torch_spmd_seqpar.py``,
``test_torch_spmd_seqpar_families.py``,
``test_torch_spmd_seqpar_encdec.py``) takes the train step of each case of
a table (an arch, its MoE dispatch, an override set and config changes),
and ``run_ragged_serve_ranks``
(``tests/test_torch_spmd_moe_ragged_serve.py``) the ragged dispatch's
prefill and decode steps.  ``run_hybrid_ranks``
(``tests/test_torch_spmd_hybrid.py``) takes the hybrid family's train
step and ``ssd_chunked`` alone on DTensors; ``run_hybrid_serve_ranks``
(``tests/test_torch_spmd_hybrid_serve.py``) its prefill and greedy decode.
``run_xlstm_ranks`` (``tests/test_torch_spmd_xlstm.py``) takes the xLSTM
family's train step, and ``_mlstm_parallel`` and ``slstm_seq`` alone on
DTensors; ``run_xlstm_serve_ranks``
(``tests/test_torch_spmd_xlstm_serve.py``) its prefill and greedy decode.
``run_encdec_ranks`` (``tests/test_torch_spmd_encdec.py``) takes the
encoder-decoder's train step, and ``run_encdec_serve_ranks``
(``tests/test_torch_spmd_encdec_serve.py``) its prefill and greedy decode,
with the cross-attention K/V on the cache's shards.  ``run_pipeline_ranks``
(``tests/test_torch_spmd_pipeline.py``) runs the GPipe pipeline with one
stage a rank, each case of ``PIPE_CASES``, logging every message the
staged group carries and what the slow edge's wire encodes and decodes.
"""
from __future__ import annotations

import torch

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
RULES = ("generic_spec", "row_spec")
SHAPES = ((8,), (6,), (8, 12), (4, 8, 12), (2, 6, 5), (1, 4))
BATCHES = (4, 2, 1)
SEQ = 16
# the MoE train step: case -> (arch, override set)
MOE_CASES = {"mixtral-default": ("mixtral-8x7b", None),
             "mixtral-ep": ("mixtral-8x7b", "ep"),
             "mixtral-moe_w": ("mixtral-8x7b", "moe_w"),
             "deepseek-default": ("deepseek-moe-16b", None)}
MOE_STEPS = 2
# the serving steps: a prompt of PROMPT tokens into CACHE_LEN slots, then
# DECODE_STEPS steps of given tokens
SERVE_ARCHS = ("gpt2-xl", "llama3-8b", "internvl2-2b", "mixtral-8x7b")
PROMPT, CACHE_LEN, DECODE_STEPS = 16, 32, 4
# every family's steps that build_jitted builds on the process mesh:
# (arch, moe_impl or None)
BUILT = (("gpt2-xl", None), ("internvl2-2b", None),
         ("mixtral-8x7b", "capacity"), ("mixtral-8x7b", "ragged"),
         ("mixtral-8x7b", "loop"), ("zamba2-7b", None), ("xlstm-1_3b", None),
         ("seamless-m4t-large-v2", None))
# the train step by case: the arch's smoke config with its MoE dispatch
# ("impl", for the moe family), an override set's rules, parameter
# overrides and config ("set"), config changes ("cfg"), for "steps"
# Adafactor steps at batch 4 × SEQ
def _case(arch, impl=None, set_name=None, steps=2, **cfg):
    return {"arch": arch, "impl": impl, "set": set_name, "cfg": cfg,
            "steps": steps}


RAGGED_SERVE_ARCH = "mixtral-8x7b"
RAGGED_CASES = {
    "mixtral-ragged": _case("mixtral-8x7b", "ragged"),
    "mixtral-ragged-ep": _case("mixtral-8x7b", "ragged", "ep"),
    "deepseek-ragged": _case("deepseek-moe-16b", "ragged"),
    "mixtral-loop": _case("mixtral-8x7b", "loop")}
SEQPAR_CASES = {
    "llama3-seqpar": _case("llama3-8b", set_name="seqpar"),
    "gpt2-seqpar": _case("gpt2-xl", set_name="seqpar"),
    "mixtral-ep_seqpar": _case("mixtral-8x7b", "capacity", "ep_seqpar"),
    "mixtral-moe_w_seqpar": _case("mixtral-8x7b", "capacity",
                                  "moe_w_seqpar"),
    "mixtral-ragged-seqpar": _case("mixtral-8x7b", "ragged", "seqpar"),
    "llama3-seqpar_dots": _case("llama3-8b", set_name="seqpar_dots",
                                remat=True)}
# the hybrid family: zamba2-smoke cut to 7 layers (3 groups of 2, each
# followed by one of the 2 shared blocks, and a 1-layer tail); 4 × 16
# tokens span two SSD chunks of 8
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_STEPS = "zamba2-7b", 7, 2
# the SSD alone: (batch, seq, heads, head_dim, d_state), chunk
SSD_SHAPE, SSD_CHUNK = (4, 16, 8, 32, 16), 8
# the xLSTM family: xlstm-smoke cut to 5 layers (2 groups of one mLSTM and
# one sLSTM block, then a 1-layer mLSTM tail)
XLSTM_ARCH, XLSTM_LAYERS, XLSTM_STEPS = "xlstm-1_3b", 5, 2
# the two xLSTM kernels alone: (batch, seq, heads, head_dim) of the mLSTM's
# parallel form and of the sLSTM (d_model = heads × head_dim); the sLSTM
# also runs at SLSTM_SHORT steps, to show that its collectives a call do
# not grow with the sequence
MLSTM_SHAPE, SLSTM_SHAPE, SLSTM_SHORT = (4, 16, 4, 16), (4, 16, 4, 8), 4
# the encoder-decoder: seamless-smoke at 2 + 2 layers with its vocabulary
# padded (500 classes to 512), so the head's mask runs on DTensors
ENCDEC_ARCH, ENCDEC_STEPS = "seamless-m4t-large-v2", 2
ENCDEC_PAD = dict(name="seamless-smoke-pad", n_layers=4, n_enc_layers=2,
                  vocab=500, vocab_pad_to=64)
# seqpar on the other families: the cuts above (the xLSTM's step 1 alone:
# the sLSTM bias's rounding noise reaches every leaf in step 2)
SEQPAR_FAMILY_CASES = {
    "zamba2-seqpar": _case(HYBRID_ARCH, set_name="seqpar",
                           n_layers=HYBRID_LAYERS),
    "xlstm-seqpar": _case(XLSTM_ARCH, set_name="seqpar", steps=1,
                          n_layers=XLSTM_LAYERS)}
SEQPAR_ENCDEC_CASES = {
    "encdec-seqpar": _case(ENCDEC_ARCH, set_name="seqpar", **ENCDEC_PAD)}
# the pipeline with one stage a rank: gpt2-smoke cut to PIPE_LAYERS layers,
# batch PIPE_BATCH × PIPE_SEQ in PIPE_MICRO micro-batches; case -> (mesh
# shape, axes, base ratio, use_kernel, tied embeddings)
PIPE_LAYERS, PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 8, 8, 32, 4
PIPE_LR = 3e-4
PIPE_CASES = {
    "model4": ((4,), ("model",), 1.0, False, False),
    "pod_r1_global": ((2, 2), ("pod", "model"), 1.0, False, False),
    "pod_r1_auto": ((2, 2), ("pod", "model"), 1.0, "auto", False),
    "pod_r10_global": ((2, 2), ("pod", "model"), 10.0, False, False),
    "pod_r10_auto": ((2, 2), ("pod", "model"), 10.0, "auto", False),
    "data_model": ((2, 2), ("data", "model"), 1.0, False, False),
    "pod_r10_auto_tied": ((2, 2), ("pod", "model"), 10.0, "auto", True)}


# the JAX side's helpers, for the subprocess scripts of the test files: a
# tree from an npz's "prefix/a/b" keys, and every addressable shard of a
# tree's leaves saved by mesh position with its index
JAX_HELPERS = """
def tree(prefix):
    t = {}
    for key in z.files:
        if key.startswith(prefix):
            *parts, last = key[len(prefix):].split("/")
            node = t
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = jax.numpy.asarray(z[key])
    return t

def pstr(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name",
                                                 getattr(p, "idx", p))))
                    for p in path)

def index(idx, shape):
    return np.array([[s.start or 0, d if s.stop is None else s.stop]
                     for s, d in zip(idx, shape)],
                    dtype=np.int64).reshape(-1, 2)

def shards(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = prefix + pstr(path)
        for s in leaf.addressable_shards:
            i = pos[s.device.id]
            out[f"{key}@{i}"] = np.asarray(s.data)
            out[f"{key}@{i}#index"] = index(s.index, leaf.shape)
"""


# JAX's side of the tables of cases (RAGGED_CASES and the like), for the
# subprocess of the test files: each case's train step under its set, its
# losses, grad_norm and every shard after each step, under "<case>/"
JAX_CASES_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import resolve
from repro.configs.base import InputShape
from repro.distributed.sharding import use_mesh
from repro.distributed.steps import build_jitted
from repro.optim import adafactor
from repro.perf import overrides

CASES = {cases!r}
z = np.load(sys.argv[1])
out = {{}}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
pos = {{d.id: i for i, d in enumerate(mesh.devices.flat)}}
{helpers}
for name, case in CASES.items():
    cfg = resolve(case["arch"]).smoke
    if cfg.family == "moe":
        cfg = cfg.replace(moe_impl=case["impl"] or "capacity")
    ov = overrides.get(case["set"]) or {{}}
    cfg = cfg.replace(**{{**(ov.get("cfg") or {{}}), **case["cfg"]}})
    B, S = z[f"{{name}}/batch0/tokens"].shape
    fn, _, _ = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"),
                            param_overrides=ov.get("param_overrides"))
    params = tree(f"{{name}}/weights/")
    state = adafactor(1e-3).init(params)
    keys = [k.rsplit("/", 1)[1] for k in z.files
            if k.startswith(f"{{name}}/batch0/")]
    for i in range(case["steps"]):
        batch = {{k: z[f"{{name}}/batch{{i}}/{{k}}"] for k in keys}}
        with use_mesh(mesh, ov.get("rules")):
            params, state, m = fn(params, state, batch)
        out[f"{{name}}/loss{{i}}"] = np.asarray(m["loss"])
        out[f"{{name}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        shards(f"{{name}}/shard{{i}}/param/", params)
        shards(f"{{name}}/shard{{i}}/opt/", state)
np.savez(sys.argv[2], **out)
"""


def flat_arrays(tree, prefix, out) -> None:
    """A nested dict of arrays into ``out`` under "prefix/a/b" keys."""
    for k, v in tree.items():
        if isinstance(v, dict):
            flat_arrays(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def _write_npz(path, arrays) -> None:
    """``arrays`` into the npz ``path``, which appears whole at once."""
    import os
    import numpy as np
    with open(path + ".part", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".part", path)


def index_rows(offset, local_shape):
    """A shard's index as JAX's scripts save it: one [start, stop) row a
    dimension."""
    import numpy as np
    return np.array([[o, o + n] for o, n in zip(offset, local_shape)],
                    dtype=np.int64).reshape(-1, 2)


def smoke_cfg(arch, moe_impl="capacity"):
    """The arch's smoke config; the moe family with ``moe_impl`` (the
    capacity dispatch by default, as at full size)."""
    from repro_torch.configs import resolve
    cfg = resolve(arch).smoke
    return cfg.replace(moe_impl=moe_impl) if cfg.family == "moe" else cfg


def hybrid_cfg():
    """zamba2-smoke with HYBRID_LAYERS layers."""
    from repro_torch.configs import resolve
    return resolve(HYBRID_ARCH).smoke.replace(n_layers=HYBRID_LAYERS)


def xlstm_cfg():
    """xlstm-smoke with XLSTM_LAYERS layers."""
    from repro_torch.configs import resolve
    return resolve(XLSTM_ARCH).smoke.replace(n_layers=XLSTM_LAYERS)


def encdec_cfg():
    """seamless-smoke as ENCDEC_PAD cuts and pads it."""
    from repro_torch.configs import resolve
    return resolve(ENCDEC_ARCH).smoke.replace(**ENCDEC_PAD)


def cases():
    """(case id, mesh name, rule, tensor shape) of the placement test."""
    out = []
    for mesh in MESHES:
        for rule in RULES:
            for shape in SHAPES:
                out.append((f"{mesh}-{rule}-{'x'.join(map(str, shape))}",
                            mesh, rule, shape))
        for b in BATCHES:
            out.append((f"{mesh}-batch_spec-{b}", mesh, "batch_spec",
                        (b, SEQ)))
    return out


def port_spec(mesh, rule, shape):
    from repro_torch.distributed import params as t_params
    if rule == "batch_spec":
        spec = list(t_params.batch_spec(shape[0], mesh))
        spec += [None] * (len(shape) - len(spec))
        return t_params.P(*spec[:len(shape)])
    return getattr(t_params, rule)(shape, mesh)


def _local(d) -> dict:
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        d.shape, d.device_mesh, d.placements)
    local = d.to_local()
    if local.dtype == torch.bfloat16:
        local = local.float()
    return {"values": local.detach().cpu().numpy(), "shape": tuple(shape),
            "offset": tuple(offset)}


def _leaves_by_path(tree) -> dict:
    from repro_torch.distributed.params import (tree_map_with_path,
                                                tree_path_str)
    out = {}
    tree_map_with_path(
        lambda path, t: out.__setitem__(tree_path_str(path), t), tree)
    return out


def _placements(dev) -> dict:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.mesh import make_process_mesh

    meshes = {name: make_process_mesh(shape, axes, dev)
              for name, (shape, axes) in MESHES.items()}
    out = {}
    for cid, mname, rule, shape in cases():
        mesh = meshes[mname]
        sh = NamedSharding(mesh, port_spec(mesh, rule, shape))
        full = torch.arange(int(torch.tensor(shape).prod()),
                            dtype=torch.float32).reshape(shape)
        d = distribute_tensor(full, mesh.device_mesh, sh.placements)
        out[cid] = {"spec": tuple(sh.spec), **_local(d),
                    "coordinate": mesh.coordinate()}
    return out


def _constrain(dev) -> dict:
    from repro_torch.distributed import sharding as t_sh
    from repro_torch.launch.mesh import make_local_mesh, make_process_mesh

    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    x = t_sh.distribute(torch.arange(24.).reshape(4, 6),
                        t_sh.NamedSharding(mesh, t_sh.P()))
    out = {"local_mesh": tuple(make_local_mesh("cpu").shape.values())}
    with t_sh.use_mesh(mesh):
        for axes in (("batch", "model"), ("batch", None), (None, "vocab"),
                     ("seq", "act_seq")):
            y = t_sh.constrain(x, axes)
            want = t_sh.NamedSharding(mesh, t_sh.logical_to_spec(axes))
            out[axes] = {"placements": [str(p) for p in y.placements],
                         "want": [str(p) for p in want.placements],
                         "same_values": bool(torch.equal(y.full_tensor(),
                                                         x.full_tensor()))}
        try:
            t_sh.constrain(torch.zeros(4, 6), ("batch", "model"))
            out["plain"] = "passed"
        except TypeError as e:
            out["plain"] = f"TypeError: {e}"
    return out


def _train(dev, cfg, run, every_step=False) -> dict:
    """``build_jitted``'s train step on ``run``'s weights and batches: the
    losses and ``grad_norm`` a step, every leaf's local shard after the
    last step, and on rank 0 the unsharded step's losses and the gathered
    parameters.  With ``every_step``, also the shards after each step
    (``step_shards``), and where ``run`` names a ``step1_file``, rank 0
    writes the gathered parameters and Adafactor factors after step 1 to
    it (an npz of "params/..." and "inner/..." keys, in place at once),
    for a JAX step from the same state."""
    from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted, make_train_step
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.optim import adafactor

    batches = [{k: torch.as_tensor(v, device=dev, dtype=torch.long
                                   if v.dtype.kind == "i" else None)
                for k, v in b.items()} for b in run["batches"]]
    B, S = batches[0]["tokens"].shape
    S += cfg.n_prefix
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    fn, _, meta = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"))
    p_sh, o_sh, b_sh = meta["in_shardings"]
    params = from_numpy_tree(run["params"], dev, p_sh)
    opt = adafactor(1e-3)
    state = opt.init(params)
    out = {"losses": [], "grad_norms": [], "step_shards": []}
    for i, b in enumerate(batches):
        with use_mesh(mesh):
            params, state, m = fn(params, state, shard_tree(b, b_sh))
        out["losses"].append(float(m["loss"].full_tensor()))
        out["grad_norms"].append(float(m["grad_norm"].full_tensor()))
        out["shards"] = {**{"param/" + k: _local(v)
                            for k, v in _leaves_by_path(params).items()},
                         **{"opt/" + k: _local(v)
                            for k, v in _leaves_by_path(state).items()}}
        if every_step:
            out["step_shards"].append(out["shards"])
            if i == 0 and "step1_file" in run:   # every rank gathers
                step1 = {}
                flat_arrays({"params": to_numpy_tree(params),
                             "inner": to_numpy_tree(state.inner)}, "", step1)
                if torch.distributed.get_rank() == 0:
                    _write_npz(run["step1_file"], step1)
    gathered = to_numpy_tree(params)           # a collective: every rank
    if torch.distributed.get_rank() == 0:
        whole = from_numpy_tree(run["params"], dev)
        st = opt.init(whole)
        step = make_train_step(cfg, opt)
        out["unsharded_losses"] = []
        for b in batches:
            whole, st, m = step(whole, st, b)
            out["unsharded_losses"].append(float(m["loss"]))
        out["gathered"] = gathered
    return out


def _adamw(dev, run) -> dict:
    """One AdamW step of gpt2-smoke sharded, against the port's unsharded
    step on every rank: the loss, and the largest gap of a local shard to
    its slice of the unsharded parameters and moments."""
    from repro_torch.checkpoint import from_numpy_tree
    from repro_torch.configs import resolve
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted, make_train_step
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.optim import adamw

    cfg = resolve("gpt2-xl").smoke
    b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
         for k, v in run["batches"][0].items()}
    B, S = b["tokens"].shape
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    opt = adamw(1e-3)
    fn, _, meta = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"),
                               opt)
    p_sh, _, b_sh = meta["in_shardings"]
    params = from_numpy_tree(run["params"], dev, p_sh)
    with use_mesh(mesh):
        new, state, m = fn(params, opt.init(params), shard_tree(b, b_sh))
    whole = from_numpy_tree(run["params"], dev)
    w_new, w_state, w_m = make_train_step(cfg, opt)(whole, opt.init(whole),
                                                    b)

    def gap(sharded, unsharded):
        """(largest |sharded - unsharded|, entries off atol 1e-6 + rtol
        1e-4, entries)."""
        worst, off, n = 0.0, 0, 0
        want = _leaves_by_path(unsharded)
        for key, d in _leaves_by_path(sharded).items():
            got = _local(d)
            sl = tuple(slice(o, o + n) for o, n in zip(got["offset"],
                                                        got["shape"]))
            w = want[key][sl].numpy()
            diff = abs(got["values"] - w)
            worst = max(worst, float(diff.max()))
            off += int((diff > 1e-6 + 1e-4 * abs(w)).sum())
            n += diff.size
        return worst, off, n
    return {"loss": float(m["loss"].full_tensor()),
            "unsharded_loss": float(w_m["loss"]),
            "step": int(state.step.full_tensor()), "lr": 1e-3,
            "params_gap": gap(new, w_new),
            "moments_gap": gap(state.inner, w_state.inner)}


def run_ranks(rank, dev, runs) -> dict:
    from repro_torch.configs import resolve
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {"placements": _placements(dev), "constrain": _constrain(dev),
           "train": {arch: _train(dev, resolve(arch).smoke, run)
                     for arch, run in runs.items()},
           "adamw": _adamw(dev, runs["gpt2-xl"])}
    out["staged"] = spmd.staged_counts()
    return out


def fail_on_rank_1(rank, dev):
    if rank == 1:
        raise ValueError("rank 1 stops here")
    torch.distributed.barrier()
    return rank


def _built(dev) -> dict:
    """What ``build_jitted`` makes of each step kind of every case of
    BUILT on the process mesh: "built", or the error it raised."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.steps import build_jitted
    from repro_torch.launch.mesh import make_process_mesh

    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    out = {}
    for arch, impl in BUILT:
        cfg = smoke_cfg(arch, impl) if impl else smoke_cfg(arch)
        for kind in ("train", "prefill", "decode"):
            try:
                build_jitted(cfg, mesh, InputShape(kind, SEQ, 4, kind))
                out[(arch, impl, kind)] = "built"
            except Exception as e:     # noqa: BLE001 - the test names it
                out[(arch, impl, kind)] = f"{type(e).__name__}: {e}"
    return out


def _moe_train(dev, arch, set_name, run) -> dict:
    from repro_torch.checkpoint import from_numpy_tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted, make_train_step
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import moe
    from repro_torch.optim import adafactor
    from repro_torch.perf import overrides

    cfg = smoke_cfg(arch)
    ov = overrides.get(set_name) or {}
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in b.items()} for b in run["batches"]]
    B, S = batches[0]["tokens"].shape
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    fn, _, meta = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"),
                               param_overrides=ov.get("param_overrides"))
    p_sh, _, b_sh = meta["in_shardings"]
    params = from_numpy_tree(run["params"], dev, p_sh)
    opt = adafactor(1e-3)
    state = opt.init(params)
    out = {"losses": [], "grad_norms": [], "dropped": []}
    plan = moe.capacity_plan
    for b in batches:
        dropped = []

        def counted(*a, **kw):
            got = plan(*a, **kw)
            dropped.append(int((~got.keep).sum()))
            return got
        moe.capacity_plan = counted
        try:
            with use_mesh(mesh, ov.get("rules")):
                params, state, m = fn(params, state, shard_tree(b, b_sh))
        finally:
            moe.capacity_plan = plan
        out["dropped"].append(dropped)
        out["losses"].append(float(m["loss"].full_tensor()))
        out["grad_norms"].append(float(m["grad_norm"].full_tensor()))
    out["shards"] = {**{"param/" + k: _local(v)
                        for k, v in _leaves_by_path(params).items()},
                     **{"opt/" + k: _local(v)
                        for k, v in _leaves_by_path(state).items()}}
    if torch.distributed.get_rank() == 0:
        whole = from_numpy_tree(run["params"], dev)
        st = opt.init(whole)
        step = make_train_step(cfg, opt)
        out["unsharded_losses"] = []
        for b in batches:
            whole, st, m = step(whole, st, b)
            out["unsharded_losses"].append(float(m["loss"]))
    return out


def run_moe_ranks(rank, dev, runs) -> dict:
    """``runs[arch]``: the weights and batches; every case of MOE_CASES."""
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {"train": {case: _moe_train(dev, arch, set_name, runs[arch])
                     for case, (arch, set_name) in MOE_CASES.items()},
           "built": _built(dev)}
    out["staged"] = spmd.staged_counts()
    return out


def case_cfg(case):
    """The config of a case of RAGGED_CASES, SEQPAR_CASES,
    SEQPAR_FAMILY_CASES or SEQPAR_ENCDEC_CASES: its arch's smoke config,
    the moe family with the case's dispatch (the capacity dispatch by
    default), then its override set's config changes and its own."""
    from repro_torch.configs import resolve
    from repro_torch.perf import overrides
    cfg = resolve(case["arch"]).smoke
    if cfg.family == "moe":
        cfg = cfg.replace(moe_impl=case["impl"] or "capacity")
    ov = overrides.get(case["set"]) or {}
    return cfg.replace(**{**(ov.get("cfg") or {}), **case["cfg"]})


def case_runs(cases, batch=4) -> dict:
    """Each case's weights (the port's ``init`` of its config at seed 0) and
    batches (``numpy.random.default_rng(1)``: tokens and labels of batch
    × SEQ, and the encoder-decoder's frame embeddings), as numpy arrays."""
    import numpy as np
    from repro_torch.checkpoint import to_numpy_tree
    from repro_torch.distributed.steps import src_len_for
    from repro_torch.models import causal_lm, encdec
    out = {}
    for name, case in cases.items():
        cfg = case_cfg(case)
        model = encdec if cfg.family == "encdec" else causal_lm
        rng = np.random.default_rng(1)
        batches = []
        for _ in range(case["steps"]):
            b = {}
            if cfg.family == "encdec":
                b["src_embeds"] = rng.standard_normal(
                    (batch, src_len_for(cfg, SEQ), cfg.d_frontend)
                ).astype(np.float32)
            for k in ("tokens", "labels"):
                b[k] = rng.integers(0, cfg.vocab, (batch, SEQ)).astype(
                    np.int32)
            batches.append(b)
        out[name] = {"params": to_numpy_tree(model.init(
            cfg, torch.Generator().manual_seed(0))), "batches": batches}
    return out


def cases_both(cases, runs, tmp, timeout) -> tuple:
    """(JAX's results, the port's ranks' results) of the train steps of
    ``cases`` on ``runs`` (:func:`case_runs`): JAX_CASES_SCRIPT in a
    subprocess while 4 ranks run :func:`run_case_ranks` on the host-staged
    group, both in the directory ``tmp``."""
    import os
    import pathlib
    import subprocess
    import sys
    import numpy as np
    from repro_torch.launch import spmd
    arrays = {}
    for name, run in runs.items():
        flat_arrays(run["params"], f"{name}/weights/", arrays)
        for i, b in enumerate(run["batches"]):
            for k, v in b.items():
                arrays[f"{name}/batch{i}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(src))
    script = JAX_CASES_SCRIPT.format(cases=cases, helpers=JAX_HELPERS)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], env=env)
    try:
        port = spmd.run(run_case_ranks, 4, rdv_dir=str(tmp), device="cpu",
                        backend=spmd.STAGED, timeout=timeout,
                        args=(runs, cases))
        assert jax_proc.wait(timeout=timeout) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return np.load(tmp / "jax.npz"), port


def case_shards_match(jax_run, port, name, step, atol, skip=()):
    """Every leaf of the parameters and the Adafactor state after ``step``
    of case ``name``: on each mesh position the port's local shard has
    JAX's shard's shape and index, and its values within ``atol`` (but
    the leaves ``skip`` names, whose shape and index alone are held)."""
    import numpy as np
    prefix = f"{name}/shard{step}/"
    keys = {k[len(prefix):].rsplit("@", 1)[0] for k in jax_run.files
            if k.startswith(prefix) and "#" not in k}
    assert keys
    for rank, res in enumerate(port):
        shards = res["train"][name]["step_shards"][step]
        assert set(shards) == keys
        for key, got in shards.items():
            want = jax_run[f"{prefix}{key}@{rank}"]
            idx = jax_run[f"{prefix}{key}@{rank}#index"]
            assert got["shape"] == want.shape, key
            assert np.array_equal(index_rows(got["offset"], got["shape"]),
                                  idx), key
            if key.split("/", 1)[1] not in skip:
                np.testing.assert_allclose(got["values"], want, rtol=0,
                                           atol=atol, err_msg=key)


def _case_train(dev, case, run) -> dict:
    """``build_jitted``'s train step of ``case`` (its config, under its
    override set's rules and parameter overrides) on ``run``'s weights and
    batches: the losses and ``grad_norm`` a step, every leaf's local shard
    after each step, and the bytes staged a step; for each step, the
    (token, choice) entries the dispatch dropped (one count a MoE layer),
    the rows the ragged dispatch's grouped matmuls took on this rank, and
    the placements of the residual stream between blocks (the outputs of
    ``constrain(h, ("batch", "act_seq", None))``).  Rank 0 also runs the
    port's unsharded step and returns its losses."""
    from repro_torch.checkpoint import from_numpy_tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import is_dtensor, use_mesh
    from repro_torch.distributed.steps import build_jitted, make_train_step
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import causal_lm, moe
    from repro_torch.optim import adafactor
    from repro_torch.perf import overrides

    cfg = case_cfg(case)
    ov = overrides.get(case["set"]) or {}
    batches = [{k: torch.as_tensor(v, device=dev, dtype=torch.long
                                   if v.dtype.kind == "i" else None)
                for k, v in b.items()} for b in run["batches"]]
    B, S = batches[0]["tokens"].shape
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    fn, _, meta = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"),
                               param_overrides=ov.get("param_overrides"))
    p_sh, _, b_sh = meta["in_shardings"]
    params = from_numpy_tree(run["params"], dev, p_sh)
    opt = adafactor(1e-3)
    state = opt.init(params)
    out = {"losses": [], "grad_norms": [], "step_shards": [], "dropped": [],
           "grouped_rows": [], "residual": [], "staged_bytes": []}
    plan, grouped, constrain = (moe.capacity_plan, moe._grouped,
                                causal_lm.constrain)

    def counted_plan(*a, **kw):
        got = plan(*a, **kw)
        out["dropped"][-1].append(int((~got.keep).sum()))
        return got

    def counted_grouped(buf, w, sizes):
        out["grouped_rows"][-1] += sum(sizes)
        return grouped(buf, w, sizes)

    def logged(x, axes):
        y = constrain(x, axes)
        if tuple(axes) == ("batch", "act_seq", None) and is_dtensor(y):
            seen = tuple(str(q) for q in y.placements)
            if seen not in out["residual"][-1]:
                out["residual"][-1].append(seen)
        return y
    for b in batches:
        out["dropped"].append([])
        out["grouped_rows"].append(0)
        out["residual"].append([])
        spmd.reset_staged_counts()
        moe.capacity_plan, moe._grouped = counted_plan, counted_grouped
        causal_lm.constrain = logged
        try:
            with use_mesh(mesh, ov.get("rules")):
                params, state, m = fn(params, state, shard_tree(b, b_sh))
        finally:
            moe.capacity_plan, moe._grouped = plan, grouped
            causal_lm.constrain = constrain
        out["staged_bytes"].append(_staged("_bytes"))
        out["losses"].append(float(m["loss"].full_tensor()))
        out["grad_norms"].append(float(m["grad_norm"].full_tensor()))
        out["step_shards"].append(
            {**{"param/" + k: _local(v)
                for k, v in _leaves_by_path(params).items()},
             **{"opt/" + k: _local(v)
                for k, v in _leaves_by_path(state).items()}})
    if torch.distributed.get_rank() == 0:
        whole = from_numpy_tree(run["params"], dev)
        st = opt.init(whole)
        step = make_train_step(cfg, opt)
        out["unsharded_losses"] = []
        for b in batches:
            whole, st, m = step(whole, st, b)
            out["unsharded_losses"].append(float(m["loss"]))
    return out


def run_case_ranks(rank, dev, runs, cases) -> dict:
    """``runs[case]``: the weights and batches of each case of ``cases``."""
    return {"train": {name: _case_train(dev, case, runs[name])
                      for name, case in cases.items()}}


def _serve(dev, cfg, run) -> dict:
    """The sharded prefill of ``run["prompt"]`` (over ``run["src"]``'s
    frames for the encoder-decoder) and decode steps of
    ``run["tokens"]`` (or, without them, ``run["greedy"]`` greedy steps),
    and on rank 0 the unsharded steps alike."""
    from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import distribute, use_mesh
    from repro_torch.distributed.steps import (build_jitted,
                                               make_decode_step,
                                               make_prefill_step)
    from repro_torch.launch.mesh import make_process_mesh

    B = run["prompt"].shape[0]
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    pf, _, p_meta = build_jitted(cfg, mesh, InputShape(
        "prefill", CACHE_LEN, B, "prefill"))
    df, _, d_meta = build_jitted(cfg, mesh, InputShape(
        "decode", CACHE_LEN, B, "decode"))
    p_sh, b_sh = p_meta["in_shardings"]
    _, c_sh, t_sh = d_meta["in_shardings"]
    params = from_numpy_tree(run["params"], dev, p_sh)
    prompt = {"tokens": torch.as_tensor(run["prompt"], dtype=torch.long,
                                        device=dev)}
    if "prefix" in run:
        prompt["prefix_embeds"] = torch.as_tensor(run["prefix"], device=dev)
    if "src" in run:
        prompt["src_embeds"] = torch.as_tensor(run["src"], device=dev)
    given = [torch.as_tensor(t, dtype=torch.long, device=dev)
             for t in run.get("tokens", ())]

    def tokens(logits_of):
        """The given tokens, or each step's greedy token, by step."""
        for i in range(len(given) or run["greedy"]):
            yield given[i] if given else torch.argmax(
                logits_of()[:, -1], dim=-1)[:, None].to(dev)

    with use_mesh(mesh):
        logits, cache = pf(params, shard_tree(prompt, b_sh))
    out = {"logits": [logits.full_tensor().numpy()],
           "prefill_cache": {k: _local(v)
                             for k, v in _leaves_by_path(cache).items()},
           "placements": {k: [str(p) for p in v.placements]
                          for k, v in _leaves_by_path(cache).items()},
           "placements_want": {k: [str(p) for p in v.placements]
                               for k, v in _leaves_by_path(
                                   p_meta["cache_sh"]).items()}}
    out["tokens"] = []
    for t in tokens(lambda: torch.as_tensor(out["logits"][-1])):
        out["tokens"].append(t[:, 0].tolist())
        with use_mesh(mesh):
            logits, cache = df(params, cache, distribute(t, t_sh))
        out["logits"].append(logits.full_tensor().numpy())
    out["cache"] = {k: _local(v) for k, v in _leaves_by_path(cache).items()}
    out["decode_placements"] = {k: [str(p) for p in v.placements]
                                for k, v in _leaves_by_path(cache).items()}
    if torch.distributed.get_rank() == 0:
        whole = from_numpy_tree(run["params"], dev)
        logits, c = make_prefill_step(cfg, CACHE_LEN, cfg.window)(
            whole, prompt)
        step = make_decode_step(cfg, cfg.window)
        out["unsharded_logits"] = [logits.numpy()]
        out["unsharded_prefill_cache"] = to_numpy_tree(c)
        out["unsharded_tokens"] = []
        for t in tokens(lambda: logits):
            out["unsharded_tokens"].append(t[:, 0].tolist())
            logits, c = step(whole, c, t)
            out["unsharded_logits"].append(logits.numpy())
        out["unsharded_cache"] = to_numpy_tree(c)
    return out


def run_serve_ranks(rank, dev, runs) -> dict:
    """``runs[arch]``: the weights, the prompt and the decode tokens."""
    return {"serve": {arch: _serve(dev, smoke_cfg(arch), run)
                      for arch, run in runs.items()}}


def run_ragged_serve_ranks(rank, dev, run) -> dict:
    """``run``: the weights, the prompt and the number of greedy steps of
    RAGGED_SERVE_ARCH's smoke config with the ragged dispatch."""
    return {"serve": _serve(dev, smoke_cfg(RAGGED_SERVE_ARCH, "ragged"),
                            run)}


def _ssd(dev, run) -> dict:
    """``ssd_chunked`` on DTensors, batch on ``data`` and heads on
    ``model`` (B and C replicated over ``model``, A and D split by head),
    under the mesh's rules: the output's and final state's placements and
    their gaps to the unsharded ``ssd_chunked`` on the whole inputs."""
    import numpy as np
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import ssm

    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    whole = {k: torch.as_tensor(v, device=dev) for k, v in run.items()}
    heads = {"x": 2, "dt": 2, "A": 0, "D": 0}
    args = {}
    for k, t in whole.items():
        rows = Shard(0) if k not in ("A", "D") else Replicate()
        by_head = Shard(heads[k]) if k in heads else Replicate()
        args[k] = distribute_tensor(t, mesh.device_mesh, [rows, by_head])
    order = ("x", "dt", "A", "Bm", "Cm", "D")
    with use_mesh(mesh):
        y, h = ssm.ssd_chunked(*(args[k] for k in order), SSD_CHUNK)
    y_want, h_want = ssm.ssd_chunked(*(whole[k] for k in order), SSD_CHUNK)

    def rel(got, want):
        got, want = got.full_tensor().cpu().numpy(), want.cpu().numpy()
        return float(np.abs(got - want).max() / np.abs(want).max())
    return {"y_gap": rel(y, y_want), "h_gap": rel(h, h_want),
            "y_placements": [str(p) for p in y.placements],
            "h_placements": [str(p) for p in h.placements],
            "h_dtype": str(h.dtype)}


def _one_group(dev, batch) -> dict:
    """The loss and gradients of zamba2-smoke cut to 3 layers (one group,
    so the second shared block is unused, and a tail) on DTensors, against
    the unsharded ones: the loss's gap, the gradients' gap as one vector,
    and the largest |gradient| of the unused block."""
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted, loss_and_grad
    from repro_torch.configs.base import InputShape
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import causal_lm

    cfg = hybrid_cfg().replace(n_layers=3)
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    _, _, meta = build_jitted(cfg, mesh, InputShape("spmd", SEQ, 4, "train"))
    p_sh, _, b_sh = meta["in_shardings"]
    whole = causal_lm.init(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in batch.items()}
    with use_mesh(mesh):
        loss, _, grads = loss_and_grad(cfg, shard_tree(whole, p_sh),
                                       shard_tree(batch, b_sh))
    w_loss, _, w_grads = loss_and_grad(cfg, whole, batch)
    got = torch.cat([g.full_tensor().reshape(-1)
                     for g in tree_leaves(grads)]).double()
    want = torch.cat([g.reshape(-1) for g in tree_leaves(w_grads)]).double()
    unused = max(float(g.full_tensor()[1].abs().max())
                 for g in tree_leaves(grads["shared_attn"]))
    return {"loss_gap": abs(float(loss.full_tensor()) - float(w_loss))
            / float(w_loss),
            "grad_gap": float((got - want).norm() / want.norm()),
            "unused_block_max_grad": unused}


def run_hybrid_ranks(rank, dev, run) -> dict:
    """``run``: the weights and batches of the hybrid train step, and the
    SSD's inputs."""
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {"train": _train(dev, hybrid_cfg(), run), "ssd": _ssd(dev,
                                                               run["ssd"]),
           "one_group": _one_group(dev, run["batches"][0])}
    out["staged"] = spmd.staged_counts()
    return out


def run_hybrid_serve_ranks(rank, dev, run) -> dict:
    """``run``: the weights, the prompt and the number of greedy steps."""
    return {"serve": _serve(dev, hybrid_cfg(), run)}


def _grad_gap(got, want) -> float:
    """The gap of two lists of gradients as one vector, relative to its
    norm: DTensors (``got``) against plain tensors."""
    g = torch.cat([t.full_tensor().reshape(-1) for t in got]).double()
    w = torch.cat([t.reshape(-1) for t in want]).double()
    return float((g - w).norm() / w.norm())


def _rel(got, want) -> float:
    """|got - want| at most, relative to |want| at most (``got`` a
    DTensor)."""
    got = got.full_tensor().double()
    return float((got - want.double()).abs().max() / want.abs().max())


def _mlstm_alone(dev, run) -> dict:
    """``_mlstm_parallel`` on DTensors, batch on ``data`` and heads on
    ``model``, against the unsharded one on the whole inputs: the output's
    gap and placements, and the gradients of its five inputs, one vector,
    of the loss ``Σ y · g``."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import xlstm

    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    names = ("q", "k", "v", "i_pre", "f_pre")
    whole = [torch.as_tensor(run[k], device=dev).requires_grad_(True)
             for k in names]
    g = torch.as_tensor(run["g"], device=dev)
    placed = [distribute_tensor(t.detach(), mesh.device_mesh,
                                [Shard(0), Shard(2)]).requires_grad_(True)
              for t in whole]
    with use_mesh(mesh):
        y = xlstm._mlstm_parallel(*placed)
        (y * distribute_tensor(g, mesh.device_mesh, list(y.placements))
         ).sum().backward()
    y_want = xlstm._mlstm_parallel(*whole)
    (y_want * g).sum().backward()
    return {"y_gap": _rel(y, y_want.detach()),
            "y_placements": [str(p) for p in y.placements],
            "grad_gap": _grad_gap([t.grad for t in placed],
                                  [t.grad for t in whole])}


def _slstm_alone(dev, run) -> dict:
    """``slstm_seq`` on DTensors, batch on ``data``, the input's features
    and the weights placed by the parameter rules (heads on ``model``),
    against the unsharded one: the outputs' and final state's gaps and
    placements, and the gradients of the input and of the weights, one
    vector, of the loss ``Σ h · g + Σ_state s``.  Then the staged calls
    made within the time loop's call (``xlstm._slstm_run``: the
    redistributions around the loop and the loop) at SLSTM_SHAPE's steps
    and at SLSTM_SHORT."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.core.rad import tree_map
    from repro_torch.distributed.params import param_shardings, shard_tree
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import xlstm

    B, S, nh, hd = SLSTM_SHAPE
    cfg = xlstm.XLSTMCfg(d_model=nh * hd, n_heads=nh)
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    p_whole = tree_map(lambda a: torch.as_tensor(a, device=dev),
                       run["params"])
    x_whole = torch.as_tensor(run["x"], device=dev)
    g = torch.as_tensor(run["g"], device=dev)

    def loss(p, x, g_of):
        h, st = xlstm.slstm_seq(p, x, cfg)
        return (h * g_of(h)).sum() + sum(s.sum() for s in st), h, st

    def sharded(seq):
        p = tree_map(lambda t: t.requires_grad_(True),
                     shard_tree(p_whole, param_shardings(p_whole, mesh)))
        x = distribute_tensor(x_whole[:, :seq], mesh.device_mesh,
                              [Shard(0), Shard(2)]).requires_grad_(True)
        with use_mesh(mesh):
            out, h, st = loss(p, x, lambda h: distribute_tensor(
                g[:, :seq], mesh.device_mesh, list(h.placements)))
            out.backward()
        return p, x, h, st

    p, x, h, st = sharded(S)
    pw = tree_map(lambda t: t.clone().requires_grad_(True), p_whole)
    xw = x_whole.clone().requires_grad_(True)
    out_w, h_w, st_w = loss(pw, xw, lambda _: g)
    out_w.backward()
    res = {"h_gap": _rel(h, h_w.detach()),
           "state_gap": max(_rel(a, b.detach()) for a, b in zip(st, st_w)),
           "h_placements": [str(q) for q in h.placements],
           "state_placements": [str(q) for q in st.c.placements],
           "grad_gap": _grad_gap(
               [x.grad] + [t.grad for t in tree_leaves(p)],
               [xw.grad] + [t.grad for t in tree_leaves(pw)])}
    loop = xlstm._slstm_run

    def counted(*args):
        before = spmd.staged_counts()
        out = loop(*args)
        res[f"staged_{seq}"] = {
            k: v - before.get(k, 0) for k, v in spmd.staged_counts().items()
            if k.endswith("_calls") and v > before.get(k, 0)}
        return out
    xlstm._slstm_run = counted
    try:
        for seq in (S, SLSTM_SHORT):
            sharded(seq)
    finally:
        xlstm._slstm_run = loop
    return res


def run_xlstm_ranks(rank, dev, run) -> dict:
    """``run``: the weights and batches of the xLSTM train step, and the
    inputs of ``_mlstm_parallel`` and ``slstm_seq`` alone."""
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {"train": _train(dev, xlstm_cfg(), run, every_step=True),
           "mlstm": _mlstm_alone(dev, run["mlstm"]),
           "slstm": _slstm_alone(dev, run["slstm"])}
    out["staged"] = spmd.staged_counts()
    return out


def _staged(suffix) -> int:
    """This process's staged ``suffix`` so far: "_calls" or "_bytes"."""
    from repro_torch.launch import spmd
    return sum(v for k, v in spmd.staged_counts().items()
               if k.endswith(suffix))


def _serve_logged(dev, cfg, run, model, inner=None) -> dict:
    """:func:`_serve` of ``cfg``, and for each call of ``model.decode_step``
    (the sharded steps first, then rank 0's unsharded ones, which stage
    nothing): the shapes of the tensors the staged group carried
    (``decode_shapes``) and, where ``inner`` names a function (a (module,
    name) pair), the bytes it staged inside that function's calls within
    the step (``inner_staged_bytes``)."""
    from repro_torch.launch import spmd

    shapes, inner_bytes, open_step = [], [], [False]
    carry, decode = spmd.HostStagedGroup._run, model.decode_step

    def logged(self, name, outs, ins, call, in_place=False):
        if open_step[0]:
            shapes[-1].extend(tuple(t.shape) for t in list(ins) + list(outs))
        return carry(self, name, outs, ins, call, in_place)

    def decoding(*args, **kwargs):
        shapes.append([])
        inner_bytes.append(0)
        open_step[0] = True
        try:
            return decode(*args, **kwargs)
        finally:
            open_step[0] = False

    def counted(*args):
        before = _staged("_bytes")
        out = fn(*args)
        if open_step[0]:
            inner_bytes[-1] += _staged("_bytes") - before
        return out

    spmd.HostStagedGroup._run = logged
    model.decode_step = decoding
    if inner:
        fn = getattr(*inner)
        setattr(*inner, counted)
    try:
        out = _serve(dev, cfg, run)
    finally:
        spmd.HostStagedGroup._run = carry
        model.decode_step = decode
        if inner:
            setattr(*inner, fn)
    return {"serve": out, "decode_shapes": shapes,
            "inner_staged_bytes": inner_bytes}


def run_xlstm_serve_ranks(rank, dev, run) -> dict:
    """``run``: the weights, the prompt and the number of greedy steps.
    Besides the serving results, :func:`_serve_logged`'s, ``inner`` the
    mLSTM blocks' matrix-memory update."""
    from repro_torch.models import causal_lm, xlstm
    return _serve_logged(dev, xlstm_cfg(), run, causal_lm,
                         (xlstm, "_matrix_step_on_shards"))


def run_encdec_ranks(rank, dev, run) -> dict:
    """``run``: the weights and batches of the encoder-decoder's train
    step."""
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {"train": _train(dev, encdec_cfg(), run, every_step=True)}
    out["staged"] = spmd.staged_counts()
    return out


def _staged_besides(mod, name, skip, suffix, log):
    """Replaces ``mod.name`` by a wrapper that appends to ``log``, for each
    call, the staged ``suffix`` (:func:`_staged`) it made besides that of
    the calls of ``mod.skip`` within it.  Returns the function replaced."""
    fn, inner = getattr(mod, name), getattr(mod, skip)

    def wrapped(*args):
        spent = [0]

        def skipped(*a):
            before = _staged(suffix)
            out = inner(*a)
            spent[0] += _staged(suffix) - before
            return out
        before = _staged(suffix)
        setattr(mod, skip, skipped)
        try:
            out = fn(*args)
        finally:
            setattr(mod, skip, inner)
        log.append(_staged(suffix) - before - spent[0])
        return out
    setattr(mod, name, wrapped)
    return fn


def run_encdec_serve_ranks(rank, dev, run) -> dict:
    """``run``: the weights, the frames, the prompt and the number of
    greedy steps.  Besides the serving results and :func:`_serve_logged`'s
    shapes, for each call of ``encdec._cross_kv`` and of
    ``encdec._cross_attn`` (the sharded prefill's layers first, then the
    sharded decode steps', then rank 0's unsharded calls), what it staged
    besides its projections (``encdec.dense``): the calls that move the
    K/V onto the cache's shards (``cross_kv_staged_calls``), and the bytes
    of the attention over them (``cross_attn_staged_bytes``)."""
    from repro_torch.models import encdec

    kv_calls, attn_bytes = [], []
    saved = {name: _staged_besides(encdec, name, "dense", suffix, log)
             for name, suffix, log in (("_cross_kv", "_calls", kv_calls),
                                       ("_cross_attn", "_bytes",
                                        attn_bytes))}
    try:
        out = _serve_logged(dev, encdec_cfg(), run, encdec)
    finally:
        for name, fn in saved.items():
            setattr(encdec, name, fn)
    return dict(out, cross_kv_staged_calls=kv_calls,
                cross_attn_staged_bytes=attn_bytes)


def pipeline_cfg(tied=False):
    """gpt2-smoke with PIPE_LAYERS layers (its embeddings tied, or not)."""
    from repro_torch.configs import resolve
    cfg = resolve("gpt2-xl").smoke.replace(n_layers=PIPE_LAYERS,
                                           max_seq=PIPE_SEQ)
    return cfg.replace(tie_embeddings=True) if tied else cfg


def _log_calls(cls, name, log, entry):
    """``cls.name`` replaced, for this process, by a wrapper that appends
    ``entry(self, args, result)`` to ``log`` (unless it is ``None``)."""
    fn = getattr(cls, name)

    def logged(self, *args):
        out = fn(self, *args)
        item = entry(self, args, out)
        if item is not None:
            log.append(item)
        return out
    setattr(cls, name, logged)


def _staged_p2p(rank) -> dict:
    """Rank 0 sends rank 1 a float and an int tensor, tags 5 and 6; rank 1
    receives them by tag."""
    import torch.distributed as dist
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {}
    if rank == 0:
        dist.send(torch.arange(6, dtype=torch.float32) / 4, 1, tag=5)
        dist.send(torch.arange(3, dtype=torch.int32) + 7, 1, tag=6)
    elif rank == 1:
        a, b = torch.empty(6), torch.empty(3, dtype=torch.int32)
        dist.recv(a, 0, tag=5)
        dist.recv(b, 0, tag=6)
        out["received"] = [a.tolist(), b.tolist()]
    out["staged"] = spmd.staged_counts()
    dist.barrier()
    return out


def _pipeline_refusals(dev) -> dict:
    """``make_pipeline_train_fn`` of each non-dense family's smoke config
    on a process mesh: the error it raises."""
    from repro_torch.configs import resolve
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh((4,), ("model",), dev)
    out = {}
    for arch in ("mixtral-8x7b", "zamba2-7b", "xlstm-1_3b",
                 "seamless-m4t-large-v2", "internvl2-2b"):
        try:
            pipe.make_pipeline_train_fn(resolve(arch).smoke, mesh,
                                        PIPE_MICRO)
            out[arch] = "built"
        except NotImplementedError as e:
            out[arch] = f"NotImplementedError: {e}"
    return out


def _pipeline_case(dev, name, run, messages, wire) -> dict:
    """One case of PIPE_CASES on this rank: the loss, the local shard of
    every gradient and of the parameters after one AdamW step, the
    messages the staged group carried in the call and the slow edge's
    wire (what it encoded and decoded), and the argument bytes against
    the shardings' sum; rank 0 also runs the single-process pipeline on
    the whole weights."""
    import math
    import torch.distributed as dist
    from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.distributed.steps import value_and_grad
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_mesh, make_process_mesh
    from repro_torch.optim import adamw

    shape, axes, ratio, kern, tied = PIPE_CASES[name]
    cfg = pipeline_cfg(tied)
    mesh = make_process_mesh(shape, axes, dev)
    sh = pipe.pipeline_shardings(cfg, mesh)
    params = from_numpy_tree(run["params"][tied], dev, sh)
    batch = pipe.microbatch({k: torch.as_tensor(v, dtype=torch.long,
                                                device=dev)
                             for k, v in run["batch"].items()}, PIPE_MICRO)
    fn = pipe.make_pipeline_train_fn(cfg, mesh, PIPE_MICRO, ratio,
                                     use_kernel=kern)
    messages.clear()
    wire.clear()
    spmd.reset_staged_counts()
    loss, grads = value_and_grad(lambda p: fn(p, batch), params)
    staged = spmd.staged_counts()
    sent = list(messages)
    opt = adamw(PIPE_LR)
    state = opt.init(params)
    new, _ = opt.update(grads, state, params)
    out = {"loss": float(loss), "coordinate": mesh.coordinate(),
           "grads": {k: _local(v)
                     for k, v in _leaves_by_path(grads).items()},
           "new": {k: _local(v) for k, v in _leaves_by_path(new).items()},
           "moments_placed_as_params": all(
               tuple(m.placements) == tuple(p.placements)
               for m, p in zip(tree_leaves(state.inner["m"]),
                               tree_leaves(params))),
           "argument_bytes": sum(t.to_local().numel() * t.element_size()
                                 for t in tree_leaves(params)),
           "argument_bytes_want": sum(
               math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
               for t, s in zip(tree_leaves(params), tree_leaves(sh))),
           "messages": sent, "staged": staged,
           "wire": [(way, t.numpy()) for way, t in wire]}
    if not kern:          # the entry point: its default policy is False
        step = pipe.make_pipeline_train_step(cfg, mesh, opt, PIPE_MICRO,
                                             ratio)
        stepped, st, m = step(params, opt.init(params), batch)
        out["step_equal"] = float(m["loss"]) == float(loss) and all(
            torch.equal(a.to_local(), b.to_local())
            for a, b in zip(tree_leaves(stepped), tree_leaves(new)))
    if dist.get_rank() == 0:
        whole = from_numpy_tree(run["params"][tied], dev)
        single = pipe.make_pipeline_train_fn(
            cfg, make_mesh(shape, axes, [dev] * math.prod(shape)),
            PIPE_MICRO, ratio, use_kernel=kern)
        s_loss, s_grads = value_and_grad(lambda p: single(p, batch), whole)
        out["single"] = {"loss": float(s_loss),
                         "grads": to_numpy_tree(s_grads)}
    return out


def run_pipeline_ranks(rank, dev, run) -> dict:
    """``run``: the weights (``params[tied]``) and the batch.  The staged
    group's point-to-point plumbing, the refusals, then every case of
    PIPE_CASES; each message the staged group sends or receives is logged
    as (kind, peer, tag, bytes), and each tensor the slow edge's wire
    encodes or decodes as (kind, tensor)."""
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.launch import spmd

    out = {"p2p": _staged_p2p(rank), "refusals": _pipeline_refusals(dev)}
    messages, wire = [], []
    for kind in ("send", "recv"):
        _log_calls(spmd.HostStagedGroup, kind, messages,
                   lambda self, a, _, kind=kind: (
                       kind, a[1], a[2],
                       sum(t.numel() * t.element_size() for t in a[0])))
    _log_calls(pipe._Wire, "encode", wire,
               lambda self, a, _: None if self.mode is None
               else ("encode", a[0].detach().clone()))
    _log_calls(pipe._Wire, "decode", wire,
               lambda self, a, out: None if self.mode is None
               else ("decode", out.detach().clone()))
    out["cases"] = {name: _pipeline_case(dev, name, run, messages, wire)
                    for name in PIPE_CASES}
    return out
