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
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from .layers import _normal, dense_init


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             n_shared: int = 0, shared_d_ff: Optional[int] = None,
             dtype=torch.float32) -> Dict[str, Any]:
    ks = split_generator(gen, 5)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)

    def ew(g, shape, scale):
        return (_normal(g, shape) * scale).to(dtype)

    p = {"router": dense_init(ks[0], d, n_experts, dtype),
         "gate": ew(ks[1], (n_experts, d, d_ff), s_in),
         "up": ew(ks[2], (n_experts, d, d_ff), s_in),
         "down": ew(ks[3], (n_experts, d_ff, d), s_out)}
    if n_shared > 0:
        sdf = shared_d_ff if shared_d_ff is not None else n_shared * d_ff
        kg, ku, kd = split_generator(ks[4], 3)
        p["shared"] = {"gate": dense_init(kg, d, sdf, dtype),
                       "up": dense_init(ku, d, sdf, dtype),
                       "down": dense_init(kd, sdf, d, dtype, scale=s_out)}
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
    group and projection (the group sizes are read on the host)."""
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


def moe_capacity(p, x: torch.Tensor, top_k: int,
                 capacity_factor: float = 1.25,
                 capacity: Optional[int] = None) -> MoEOut:
    """Static-capacity dispatch.

    Buffers: (E, C, d).  Position of each (token, choice) within its expert
    comes from a stable sort; entries with position >= C are dropped (their
    gate mass is simply lost, as in Switch/GShard).  Dropped entries are
    written to a spare slot C that is sliced off, so every kept slot is
    written exactly once.
    """
    B, S, d = x.shape
    T = B * S
    x2 = x.reshape(T, d)
    gates, idx, aux = route(p["router"], x2, top_k)
    E = p["gate"].shape[0]
    C = capacity if capacity is not None else max(
        1, int(math.ceil(T * top_k / E * capacity_factor)))

    flat_e, order, token_of = _sort_by_expert(idx, top_k)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * top_k, device=x.device) - starts[sorted_e]
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)

    buf = x2.new_zeros((E, C + 1, d))
    buf[sorted_e, torch.where(keep, pos, C)] = x2[token_of]
    buf = buf[:, :C]

    h = torch.einsum("ecd,edf->ecf", buf, p["gate"].to(x.dtype))
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, p["up"].to(x.dtype))
    out = torch.einsum("ecf,efd->ecd", h, p["down"].to(x.dtype))

    # combine: gather each kept (token, choice)'s result, weight by gate
    gflat = gates.reshape(-1)[order]
    got = out[sorted_e, pos_c] * torch.where(keep, gflat,
                                             gflat.new_zeros(()))[:, None]
    y = _combine(got, order, T, top_k)
    y = y + _shared(p, x2)
    return MoEOut(y.reshape(B, S, d), aux)


def _shared(p, x2: torch.Tensor) -> torch.Tensor:
    if "shared" not in p:
        return torch.zeros_like(x2)
    sp = p["shared"]
    h = F.silu(x2 @ sp["gate"]["w"].to(x2.dtype)) \
        * (x2 @ sp["up"]["w"].to(x2.dtype))
    return h @ sp["down"]["w"].to(x2.dtype)


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
