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


def _train(dev, arch, run) -> dict:
    from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree
    from repro_torch.configs import resolve
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.params import shard_tree
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted, make_train_step
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.optim import adafactor

    cfg = resolve(arch).smoke
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in b.items()} for b in run["batches"]]
    B, S = batches[0]["tokens"].shape
    mesh = make_process_mesh((2, 2), ("data", "model"), dev)
    fn, _, meta = build_jitted(cfg, mesh, InputShape("spmd", S, B, "train"))
    p_sh, o_sh, b_sh = meta["in_shardings"]
    params = from_numpy_tree(run["params"], dev, p_sh)
    opt = adafactor(1e-3)
    state = opt.init(params)
    out = {"losses": [], "grad_norms": []}
    for b in batches:
        with use_mesh(mesh):
            params, state, m = fn(params, state, shard_tree(b, b_sh))
        out["losses"].append(float(m["loss"].full_tensor()))
        out["grad_norms"].append(float(m["grad_norm"].full_tensor()))
    out["shards"] = {**{"param/" + k: _local(v)
                        for k, v in _leaves_by_path(params).items()},
                     **{"opt/" + k: _local(v)
                        for k, v in _leaves_by_path(state).items()}}
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
    from repro_torch.launch import spmd
    spmd.reset_staged_counts()
    out = {"placements": _placements(dev), "constrain": _constrain(dev),
           "train": {arch: _train(dev, arch, run)
                     for arch, run in runs.items()},
           "adamw": _adamw(dev, runs["gpt2-xl"])}
    out["staged"] = spmd.staged_counts()
    return out


def fail_on_rank_1(rank, dev):
    if rank == 1:
        raise ValueError("rank 1 stops here")
    torch.distributed.barrier()
    return rank
