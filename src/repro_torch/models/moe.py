"""Mixture-of-Experts layers (Mixtral-style top-2, DeepSeekMoE fine-grained
top-6 with shared experts).

Three execution paths, all numerically equivalent when capacity is
sufficient (tested against each other and against the JAX package):

* ``moe_loop``     — reference: loop over experts with masking (oracle for
                     tests; FLOPs scale with E);
* ``moe_ragged``   — sort tokens by expert, one matmul per non-empty expert
                     group and projection (the JAX package's
                     ``jax.lax.ragged_dot``; exact active-token FLOPs; the
                     default);
* ``moe_capacity`` — static (E, C, d) dispatch buffers built by a stable
                     sort, batched einsum over experts.  Tokens beyond
                     capacity are dropped (``capacity_factor`` sets C).

On DTensors (a process mesh) the ragged and capacity paths share one
sharded dispatch, :func:`_sharded_dispatch`; the loop runs as plain
DTensor ops.

Router: softmax over expert logits, top-k, renormalized gates, plus the
standard load-balance auxiliary loss (fraction·probability product).

The combine is deterministic on every device.  The JAX package scatters
each (token, choice) contribution with ``zeros.at[token_of].add``; its
PyTorch form, ``index_add_``, is atomic on CUDA, so with top_k >= 3 its
summation order would change from run to run and a replayed KV cache
would no longer be bit-identical.  Here the contributions are put back in
(token, choice) order — each row written once — and summed over the
choices in rank order, choice 0 (the largest gate) first.  For top_k <= 2
this is the same sum as JAX's; beyond that it differs from JAX's
expert-sorted order by rounding only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              local_offset, logical_to_spec,
                                              on_shards)
from .layers import _normal, dense, dense_init


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             n_shared: int = 0, shared_d_ff: Optional[int] = None,
             dtype=torch.float32, *, device=None) -> Dict[str, Any]:
    ks = split_generator(gen, 5)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)

    def ew(g, shape, scale):
        return (_normal(g, shape, device) * scale).to(dtype)

    p = {"router": dense_init(ks[0], d, n_experts, dtype, device=device),
         "gate": ew(ks[1], (n_experts, d, d_ff), s_in),
         "up": ew(ks[2], (n_experts, d, d_ff), s_in),
         "down": ew(ks[3], (n_experts, d_ff, d), s_out)}
    if n_shared > 0:
        sdf = shared_d_ff if shared_d_ff is not None else n_shared * d_ff
        kg, ku, kd = split_generator(ks[4], 3)
        p["shared"] = {"gate": dense_init(kg, d, sdf, dtype, device=device),
                       "up": dense_init(ku, d, sdf, dtype, device=device),
                       "down": dense_init(kd, sdf, d, dtype, scale=s_out,
                                          device=device)}
    return p


def route(p_router, x2d: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (gates (T,K), expert_idx (T,K), aux_loss)."""
    logits = (x2d @ p_router["w"].to(x2d.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                 # (T, E)
    gates, idx = torch.topk(probs, top_k, dim=-1)         # (T, K), sorted
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = logits.shape[-1]
    # load-balance aux: E * sum_e (mean prob_e) * (fraction routed to e)
    frac = torch.mean(F.one_hot(idx, E).to(torch.float32).sum(1), dim=0)
    mean_p = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac * mean_p)
    return gates.to(x2d.dtype), idx, aux


def _expert_ffn(xe: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
                down_w: torch.Tensor) -> torch.Tensor:
    h = F.silu(xe @ gate_w) * (xe @ up_w)
    return h @ down_w


def moe_loop(p, x: torch.Tensor, top_k: int) -> MoEOut:
    """Oracle: every expert on every token, masked combine."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, aux = route(p["router"], x2, top_k)
    E = p["gate"].shape[0]
    y = torch.zeros_like(x2)
    for e in range(E):
        ye = _expert_ffn(x2, p["gate"][e].to(x.dtype),
                         p["up"][e].to(x.dtype), p["down"][e].to(x.dtype))
        w_e = torch.sum(torch.where(idx == e, gates, gates.new_zeros(())),
                        dim=-1)                                  # (T,)
        y = y + ye * w_e[:, None]
    y = y + _shared(p, x2)
    return MoEOut(y.reshape(B, S, d), aux)


def _sort_by_expert(idx: torch.Tensor, top_k: int):
    """Flatten (T,K) assignments, stable-sort by expert id."""
    flat_e = idx.reshape(-1)                               # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    token_of = order // top_k
    return flat_e, order, token_of


def _combine(contrib: torch.Tensor, order: torch.Tensor, T: int,
             top_k: int) -> torch.Tensor:
    """Sum each token's ``top_k`` contributions, given in expert-sorted
    ``order``: rows back to (token, choice) order, each written once, then
    added over the choices in rank order (see the module docstring)."""
    rows = torch.empty_like(contrib).index_copy_(0, order, contrib)
    rows = rows.view(T, top_k, -1)
    y = rows[:, 0]
    for k in range(1, top_k):
        y = y + rows[:, k]
    return y


def moe_ragged(p, x: torch.Tensor, top_k: int) -> MoEOut:
    """Exact top-k MoE, tokens grouped by expert: one matmul per non-empty
    group and projection (the group sizes are read on the host).  On
    DTensors see :func:`_ragged_sharded`."""
    if is_dtensor(x):
        return _ragged_sharded(p, x, top_k)
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    gates, idx, aux = route(p["router"], x2, top_k)
    E = p["gate"].shape[0]
    flat_e, order, token_of = _sort_by_expert(idx, top_k)
    xs = x2[token_of]                                      # (T*K, d) sorted
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    parts, lo = [], 0
    for e, n in enumerate(sizes):
        if n:
            parts.append(_expert_ffn(xs[lo:lo + n], p["gate"][e].to(x.dtype),
                                     p["up"][e].to(x.dtype),
                                     p["down"][e].to(x.dtype)))
            lo += n
    ys = torch.cat(parts)                                  # (T*K, d)
    gflat = gates.reshape(-1)[order]
    y = _combine(ys * gflat[:, None], order, T, top_k)
    y = y + _shared(p, x2)
    return MoEOut(y.reshape(B, S, d), aux)


class CapacityPlan(NamedTuple):
    """Where each (token, choice) goes, in expert-sorted order: its
    expert, its slot within the expert (``C``, a spare slot, when it is
    dropped), whether it is kept, and the (token, choice) order; and how
    many entries each expert was routed."""
    order: torch.Tensor       # (T*K,) flat (token, choice) index, sorted
    token_of: torch.Tensor    # (T*K,) token of each sorted entry
    sorted_e: torch.Tensor    # (T*K,) expert of each sorted entry
    pos_c: torch.Tensor       # (T*K,) slot, 0 where dropped
    slot: torch.Tensor        # (T*K,) slot, C where dropped
    keep: torch.Tensor        # (T*K,) bool
    counts: torch.Tensor      # (E,) entries routed to each expert


def capacity_plan(idx: torch.Tensor, top_k: int, E: int,
                  C: int) -> CapacityPlan:
    """The static-capacity dispatch of routing ``idx`` (T, K): the position
    of each (token, choice) within its expert comes from a stable sort over
    all T tokens; entries with position >= C are dropped."""
    flat_e, order, token_of = _sort_by_expert(idx, top_k)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(idx.numel(), device=idx.device) - starts[sorted_e]
    keep = pos < C
    return CapacityPlan(order, token_of, sorted_e, torch.where(keep, pos, 0),
                        torch.where(keep, pos, C), keep, counts)


def moe_capacity(p, x: torch.Tensor, top_k: int,
                 capacity_factor: float = 1.25,
                 capacity: Optional[int] = None) -> MoEOut:
    """Static-capacity dispatch.

    Buffers: (E, C, d).  Position of each (token, choice) within its expert
    comes from a stable sort; entries with position >= C are dropped (their
    gate mass is simply lost, as in Switch/GShard).  Dropped entries are
    written to a spare slot C that is sliced off, so every kept slot is
    written exactly once.  On DTensors see :func:`_capacity_sharded`.
    """
    B, S, d = x.shape
    T = B * S
    E = p["gate"].shape[0]
    C = capacity if capacity is not None else max(
        1, int(math.ceil(T * top_k / E * capacity_factor)))
    if is_dtensor(x):
        return _capacity_sharded(p, x, top_k, C)
    x2 = x.reshape(T, d)
    gates, idx, aux = route(p["router"], x2, top_k)
    plan = capacity_plan(idx, top_k, E, C)

    buf = x2.new_zeros((E, C + 1, d))
    buf[plan.sorted_e, plan.slot] = x2[plan.token_of]
    buf = buf[:, :C]

    h = torch.einsum("ecd,edf->ecf", buf, p["gate"].to(x.dtype))
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, p["up"].to(x.dtype))
    out = torch.einsum("ecf,efd->ecd", h, p["down"].to(x.dtype))

    # combine: gather each kept (token, choice)'s result, weight by gate
    gflat = gates.reshape(-1)[plan.order]
    got = out[plan.sorted_e, plan.pos_c] * torch.where(
        plan.keep, gflat, gflat.new_zeros(()))[:, None]
    y = _combine(got, plan.order, T, top_k)
    y = y + _shared(p, x2)
    return MoEOut(y.reshape(B, S, d), aux)


def _capacity_sharded(p, x, top_k: int, C: int) -> MoEOut:
    """Static-capacity dispatch on DTensors, as GSPMD runs the JAX
    package's under its two ``constrain(..., ("expert_dispatch", None,
    None))`` calls: :func:`_sharded_dispatch` into (E, C, d) slots, each
    kept (token, choice) at its expert and its position within it, the
    experts batched in one einsum a projection."""
    return _sharded_dispatch(p, x, top_k, C, ragged=False)


def _ragged_sharded(p, x, top_k: int) -> MoEOut:
    """The ragged dispatch on DTensors: :func:`_sharded_dispatch` with no
    entry dropped, each rank's rows grouped by expert.  The JAX package's
    ``moe_ragged`` makes no ``constrain`` call, so GSPMD places its
    ``ragged_dot``s freely; here each mesh axis takes the mode the
    capacity dispatch would (``E`` under the ``expert_dispatch`` rule)."""
    T = x.shape[0] * x.shape[1]
    return _sharded_dispatch(p, x, top_k, T * top_k, ragged=True)


def _expert_blocks(E: int, mesh, placements) -> List[Tuple[int, int]]:
    """[start, stop) of the experts on each shard of a dimension of E
    placed by ``placements``, in the shards' order: ``Shard(0)`` on an
    axis cuts each block into chunks of ceil(len / size), as DTensor
    does."""
    from torch.distributed.tensor import Shard
    blocks = [(0, E)]
    for size, pl in zip(mesh.shape, placements):
        if pl == Shard(0):
            blocks = [(min(a + i * c, b), min(a + (i + 1) * c, b))
                      for a, b in blocks for c in [-(-(b - a) // size)]
                      for i in range(size)]
    return blocks


def _grouped(buf: torch.Tensor, w: torch.Tensor, sizes) -> torch.Tensor:
    """Rows (1, R, k) grouped by expert, ``sizes[j]`` rows of expert j in
    order, each group times its expert's ``w[j]`` (w: (n_e, k, n)): one
    matmul a group; the rows after the last group are zero.  An empty
    group still multiplies, so every expert's weight has a gradient."""
    rows, parts, lo = buf[0], [], 0
    for wj, n in zip(w.unbind(0), sizes):
        parts.append(rows[lo:lo + n] @ wj.to(rows.dtype))
        lo += n
    parts.append(rows.new_zeros((rows.shape[0] - lo, w.shape[-1])))
    return torch.cat(parts)[None]


def _sharded_dispatch(p, x, top_k: int, C: int, ragged: bool) -> MoEOut:
    """The capacity (``ragged=False``) and ragged dispatches on DTensors.

    The routing is tiny and runs whole on every rank, on the gathered
    tokens: each (token, choice)'s position within its expert counts over
    all T tokens of the global batch, so the same entries are dropped at
    capacity ``C`` on any mesh, and the router's aux loss averages over all
    T.  The expert FFN then runs on local shards of a buffer of (blocks,
    slots, d), each mesh axis in one of four modes:

    * ``E`` — the axis shards the experts (the ``expert_dispatch`` rule
      names it, as the ``ep`` set does, or the weights are placed so):
      each rank builds the buffers of its own experts and computes only
      those; the combine's partial sums meet in a reduction;
    * ``d`` — the weights' model dimension is sharded (the baseline's
      FSDP rule puts it on ``data``): the contraction is split, the
      (blocks, slots, ff) pre-activations are summed over the axis, and
      the output columns stay split;
    * ``f`` — the expert FFN width is sharded (``model`` in the baseline):
      each rank computes its slice of the width, and the output is a
      partial sum;
    * ``R`` — replicated: every rank computes the same.

    The two dispatches differ in their buffer and its matmul alone.  The
    capacity's is (E, C, d): a block an expert, a kept entry at its
    position within it, the experts batched in one einsum.  The ragged one
    keeps every entry:
    a block a shard of the experts, which holds their entries grouped by
    expert in sorted order (as many slots as the fullest shard's entries,
    the rest zero), one matmul a group; the group sizes are read on the
    host once a call, from the replicated routing.

    Every index write and gather runs on local tensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    B, S, d = x.shape
    T = B * S
    E = p["gate"].shape[0]
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    xr = x.redistribute(mesh, rep)
    w = p["router"]["w"].redistribute(mesh, rep)

    def routing(x, w):
        gates, idx, aux = route({"w": w}, x.reshape(T, d), top_k)
        return (gates, aux) + tuple(capacity_plan(idx, top_k, E, C))
    gates, aux, *plan = on_shards(routing, (rep,) * 9, xr, w)
    plan = CapacityPlan(*plan)

    modes = _ffn_modes(mesh, p["gate"].placements)
    R, P = Replicate(), Partial()
    S0, S1, S2 = Shard(0), Shard(1), Shard(2)

    def pl(**by_mode):
        return tuple(by_mode[m] for m in modes)

    buf_pl = pl(E=S0, d=R, f=R, R=R)
    if ragged:
        sizes = plan.counts.to_local().tolist()
        blocks = _expert_blocks(E, mesh, buf_pl)
        n_slots = max(1, max(sum(sizes[a:b]) for a, b in blocks))
        b0, n_b = local_offset((len(blocks), n_slots, d), mesh, buf_pl, 0)
        e_lo, e_hi = blocks[b0]
        first, n_rows = sum(sizes[:e_lo]), sum(sizes[e_lo:e_hi])
    else:
        n_slots = C
        b0, n_b = local_offset((E, C, d), mesh, buf_pl, 0)

    def landing(sorted_e, pos_c, keep, b0, n_b):
        """Each sorted (token, choice)'s block and slot in this rank's
        buffer, whose blocks are [b0, b0 + n_b), and whether it lands
        there."""
        if ragged:
            row = torch.arange(T * top_k, device=sorted_e.device) - first
            mine = (row >= 0) & (row < n_rows)
            return torch.zeros_like(row), torch.where(mine, row, 0), mine
        blk = sorted_e - b0
        mine = (blk >= 0) & (blk < n_b) & keep
        return torch.where(mine, blk, 0), pos_c, mine

    def dispatch(x, sorted_e, pos_c, keep, token_of):
        blk, slot, mine = landing(sorted_e, pos_c, keep, b0, n_b)
        buf = x.new_zeros((n_b, n_slots + 1, d))
        buf[blk, torch.where(mine, slot, n_slots)] = x.reshape(T, d)[token_of]
        return buf[:, :n_slots]
    buf = on_shards(dispatch, buf_pl, xr, plan.sorted_e, plan.pos_c,
                    plan.keep, plan.token_of,
                    in_grad_placements=(pl(E=P, d=R, f=R, R=R), None, None,
                                        None, None))
    if not ragged:
        buf = constrain(buf, ("expert_dispatch", None, None))

    if ragged:
        def mm(b, wt):
            return _grouped(b, wt, sizes[e_lo:e_hi])
    else:
        def mm(b, wt):
            return torch.einsum("ecd,edf->ecf", b, wt.to(b.dtype))
    buf = buf.redistribute(mesh, pl(E=S0, d=S2, f=R, R=R))
    w_in = pl(E=S0, d=S1, f=S2, R=R)
    hu_pl = pl(E=S0, d=P, f=S2, R=R)
    h, u = on_shards(
        lambda b, g, up: (mm(b, g), mm(b, up)),
        (hu_pl, hu_pl), buf, p["gate"].redistribute(mesh, w_in),
        p["up"].redistribute(mesh, w_in),
        in_grad_placements=(pl(E=S0, d=S2, f=P, R=R), None, None))
    act_pl = pl(E=S0, d=R, f=S2, R=R)
    h, u = h.redistribute(mesh, act_pl), u.redistribute(mesh, act_pl)
    hu_grad = pl(E=S0, d=P, f=S2, R=R)
    out = on_shards(
        lambda h, u, w: mm(F.silu(h) * u, w),
        pl(E=S0, d=S2, f=P, R=R), h, u,
        p["down"].redistribute(mesh, pl(E=S0, d=S2, f=S1, R=R)),
        in_grad_placements=(hu_grad, hu_grad, None))
    if not ragged:
        out = constrain(out, ("expert_dispatch", None, None))

    o_pl = tuple(out.placements)
    o_blocks = local_offset(out.shape, mesh, o_pl, 0)

    def combine(out, gates, sorted_e, pos_c, keep, order):
        blk, slot, mine = landing(sorted_e, pos_c, keep, *o_blocks)
        gflat = gates.reshape(-1)[order]
        got = out[blk, slot] * torch.where(
            mine, gflat, gflat.new_zeros(()))[:, None]
        return _combine(got, order, T, top_k).reshape(B, S, -1)
    # the output's blocks (dim 0) and partial sums give partial sums of y;
    # its columns (dim 2) are y's columns
    y_pl = [q if q == S2 or q == R else P for q in o_pl]
    y = on_shards(combine, y_pl, out, gates, plan.sorted_e, plan.pos_c,
                  plan.keep, plan.order,
                  in_grad_placements=(
                      [R if isinstance(q, Partial) else q for q in o_pl],
                      [R if isinstance(q, Replicate) else P for q in o_pl],
                      None, None, None, None))
    y = y.redistribute(mesh, x.placements)
    return MoEOut(y + _shared(p, x), aux)


def _ffn_modes(mesh, gate_placements) -> Tuple[str, ...]:
    """Each mesh axis's mode of the sharded expert FFN (see
    :func:`_sharded_dispatch`): ``E`` where the ``expert_dispatch`` rule
    names the axis, else what the (E, d, ff) gate weights' placement on
    it shards."""
    from torch.distributed.tensor import Shard
    ed = logical_to_spec(("expert_dispatch",))[0]
    ed = (ed,) if isinstance(ed, str) else tuple(ed or ())
    modes = []
    for name, pl in zip(mesh.mesh_dim_names, gate_placements):
        if name in ed:
            modes.append("E")
        elif isinstance(pl, Shard):
            modes.append("Edf"[pl.dim])
        else:
            modes.append("R")
    return tuple(modes)


def _shared(p, x2: torch.Tensor) -> torch.Tensor:
    if "shared" not in p:
        return torch.zeros_like(x2)
    sp = p["shared"]
    h = F.silu(dense(sp["gate"], x2)) * dense(sp["up"], x2)
    return dense(sp["down"], h)


def moe_apply(p, x: torch.Tensor, top_k: int, impl: str = "ragged",
              capacity_factor: float = 1.25) -> MoEOut:
    if impl == "loop":
        return moe_loop(p, x, top_k)
    if impl == "ragged":
        return moe_ragged(p, x, top_k)
    if impl == "capacity":
        return moe_capacity(p, x, top_k, capacity_factor)
    raise ValueError(f"unknown moe impl {impl!r}")


def moe_flops(tokens: int, d: int, d_ff: int, top_k: int,
              n_shared_ff: int = 0) -> float:
    """Active forward FLOPs (router negligible, counted anyway)."""
    routed = 2.0 * tokens * top_k * d * d_ff * 3
    shared = 2.0 * tokens * d * n_shared_ff * 3
    return routed + shared
