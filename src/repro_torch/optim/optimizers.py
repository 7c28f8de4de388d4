"""Optimizers as functional transforms over nested dicts of tensors.

Each optimizer is an (init, update) pair packaged in :class:`Optimizer`;
state and params are nested dicts with the parameters' key paths, so the
same code drives the FusionLLM decentralized runtime (per-CompNode
sub-trees — the paper's per-OP "Update" stage, §3.3) and unit tests.  The
update is written out (no ``torch.optim``) so it is the JAX package's
formula: ``update`` returns new tensors and leaves its inputs as they were,
unless the caller gives them up (``consume_grads``: a train step that owns
its gradients and its optimizer state, as the JAX package's jitted step
donates ``params`` and ``opt_state``, ``repro/distributed/steps.py``,
``donate_argnums=(0, 1)``).  Then the update computes in the gradients'
memory, and AdamW writes its new moments over those of the state it was
given, so it allocates no parameter-sized tree.  The parameters given are
never written.  AdamW's update of fp32 leaves on the card is one fused
CUDA pass over many leaves a launch (:mod:`repro_torch.kernels.adamw`).

Schedules map the step (a 0-dim int tensor) to a 0-dim float32 tensor on
the CPU, which scales tensors on any device.

On DTensor parameters (a process mesh) the update runs on DTensors.  A
moment of a parameter's shape (AdamW's, SGD's) is placed as its parameter,
as the JAX package's ``zeros_like`` places it, so the update moves
nothing; Adafactor's factors, of other shapes, are placed as the JAX
package's ``build_jitted`` places them (``generic_spec`` of each leaf's
shape); the step counter is replicated.  ``build_jitted``'s step places
its arguments by its in_shardings, whatever ``init`` chose.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.opgraph import tree_leaves
from repro_torch.core.rad import tree_map
from repro_torch.distributed.params import generic_spec
from repro_torch.distributed.sharding import (NamedSharding, is_dtensor,
                                              mesh_of, zeros)
from repro_torch.kernels import adamw as fused_adamw
from repro_torch.obs.trace import span

Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., Tuple[Any, OptState]]
    # update(grads, state, params, consume_grads=False)
    #     -> (new_params, new_state)


def _spanned(update):
    """``update`` inside the profiler span ``optim.update``: one span a
    whole update, all leaves."""
    @functools.wraps(update)
    def run(*args, **kwargs):
        with span("optim.update"):
            return update(*args, **kwargs)
    return run


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _state_zeros(p: torch.Tensor, shape, dtype=torch.float32
                 ) -> torch.Tensor:
    """Optimizer state of ``shape`` for parameter ``p``: on ``p``'s
    device, or on its process mesh placed by ``generic_spec``."""
    mesh = mesh_of(p)
    if mesh is None:
        return p.new_zeros(shape, dtype=dtype)
    return zeros(shape, dtype, NamedSharding(mesh, generic_spec(
        tuple(shape), mesh)))


def _moment(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A zero moment of ``p``'s shape: on ``p``'s device, or on its process
    mesh placed as ``p`` is."""
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.contiguous_format)


def _step0(params) -> torch.Tensor:
    """The step counter: a 0-dim int32 on the CPU, or replicated on the
    parameters' process mesh."""
    mesh = mesh_of(next(iter(tree_leaves(params)), None))
    if mesh is None:
        return torch.zeros((), dtype=torch.int32)
    return zeros((), torch.int32, NamedSharding(mesh, ()))


# -------------------------------------------------------------- schedules --
def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1
                    ) -> Schedule:
    def lr(step):
        t = torch.clamp(_f32(step), max=total_steps) / total_steps
        return base_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + torch.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step):
        s = _f32(step)
        return torch.where(s < warmup, base_lr * (s + 1) / warmup,
                           cos(torch.clamp(s - warmup, min=0)))
    return lr


def _as_sched(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: _f32(lr)


# ------------------------------------------------------------------- clip --
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before).  The gradients are scaled where they are, with the JAX
    package's numbers: the caller owns them, each leaf in memory of its
    own (:func:`distinct_storage`), and reads them only through the
    result."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g.mul_(scale), grads), gn


def distinct_storage(tree):
    """``tree`` with each leaf whose memory an earlier leaf's shares (one
    autograd gradient reaching two parameters), or whose entries share
    memory (a broadcast gradient), copied, so that a leaf can be written
    in place alone."""
    seen = set()

    def own(t):
        local = t.to_local() if is_dtensor(t) else t
        ptr = local.untyped_storage().data_ptr()
        if ptr in seen or any(st == 0 and n > 1 for st, n in
                              zip(local.stride(), local.shape)):
            return t.clone()
        seen.add(ptr)
        return t
    return tree_map(own, tree)


# -------------------------------------------------------------------- SGD --
def sgd(lr=1e-2, momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        mom = tree_map(lambda p: _moment(p, p.dtype),
                       params) if momentum else None
        return OptState(step=_step0(params), inner=mom)

    def update(grads, state, params, consume_grads=False):
        del consume_grads               # computes in new memory
        lr_t = sched(state.step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state.inner, grads)
            eff = tree_map(lambda m, g: momentum * m + g, mom, grads) \
                if nesterov else mom
            inner = mom
        else:
            eff, inner = grads, None
        new_p = tree_map(lambda p, g: (p - lr_t * g).to(p.dtype), params, eff)
        return new_p, OptState(step=state.step + 1, inner=inner)

    return Optimizer(init=init, update=_spanned(update))


# ------------------------------------------------------------------ AdamW --
def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        return OptState(step=_step0(params),
                        inner={"m": tree_map(_moment, params),
                               "v": tree_map(_moment, params)})

    def update(grads, state, params, consume_grads=False):
        """The step computes in new memory and leaves its inputs as they
        were, or with ``consume_grads`` gives up the gradients (of distinct
        memory, not read again) and the moments of ``state``: each fp32
        leaf's new parameter is written into its gradient's memory and its
        new moments over the old ones, so the update allocates nothing
        parameter-sized and holds four trees (parameters, gradients, two
        moments), not six.  That is the JAX package's contract: its jitted
        train step donates ``params`` and ``opt_state``
        (``repro/distributed/steps.py``, ``donate_argnums=(0, 1)``).  The
        parameters given are never written.

        Leaves are routed by what they are
        (:func:`repro_torch.kernels.adamw.update`): fp32 leaves on the card
        go through one fused CUDA pass over many leaves a launch, on the
        CPU through its plain version; DTensors and other dtypes through
        the written-out formula in new memory (the card's torch has refused
        sharded ops that a CPU build accepts).  Every route gives the same
        numbers, op for op."""
        t = state.step + 1
        h = fused_adamw.Hyper(
            lr=sched(state.step), b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, bc1=1 - _f32(b1) ** _f32(t),
            bc2=1 - _f32(b2) ** _f32(t))
        leaves = []
        tree_map(lambda *leaf: leaves.append(leaf), params, grads,
                 state.inner["m"], state.inner["v"])
        done = iter(fused_adamw.update(leaves, h, in_place=consume_grads))
        out = tree_map(lambda _: next(done), params)
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), OptState(step=t, inner={"m": pick(1), "v": pick(2)})

    return Optimizer(init=init, update=_spanned(update))


# -------------------------------------------------------------- Adafactor --
def adafactor(lr=1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment for matrices (memory-lean option for the
    biggest configs); falls back to full accumulators on <2D leaves.

    A leaf is taken whole, as in the JAX package: a stacked ``(L, d)``
    norm scale is a matrix, so it is factored (``r`` over its last axis,
    ``c`` over its second to last), and the update's RMS clip runs over all
    L layers of a stacked leaf at once."""
    sched = _as_sched(lr)

    def _facts(p):
        if p.dim() < 2:
            return {"v": _state_zeros(p, p.shape)}
        return {"r": _state_zeros(p, p.shape[:-1]),
                "c": _state_zeros(p, p.shape[:-2] + p.shape[-1:])}

    def init(params):
        return OptState(step=_step0(params), inner=tree_map(_facts, params))

    def update(grads, state, params, consume_grads=False):
        """The step computes in each gradient's fp32 copy, or with
        ``consume_grads`` (gradients of distinct memory that the caller
        does not read again) in an fp32 gradient itself, whose memory then
        holds the new fp32 parameter; each leaf-sized temporary is dropped
        once used (those of the largest leaf set a step's peak memory).
        In place or not, the arithmetic is the JAX package's formula's."""
        t = state.step + 1
        lr_t = sched(state.step)
        beta = 1.0 - (_f32(t) + 1.0) ** (-decay)

        def upd(p, g, f):
            g32 = g.to(torch.float32)
            if g32 is g and not consume_grads:
                g32 = g.clone()
            g2 = torch.square(g32) + eps
            if p.dim() < 2:
                v = beta * f["v"] + (1 - beta) * g2
                del g2
                nf, denom = {"v": v}, v
            else:
                r = beta * f["r"] + (1 - beta) * torch.mean(g2, dim=-1)
                c = beta * f["c"] + (1 - beta) * torch.mean(g2, dim=-2)
                del g2
                nf = {"r": r, "c": c}
                denom = (r[..., None] * c[..., None, :]
                         / torch.clamp(torch.mean(r, dim=-1, keepdim=True)
                                       [..., None], min=eps))
            # in place on the gradient alone: DTensor may leave the
            # factors' product Partial, which no in-place op keeps
            denom = denom + eps
            denom = torch.sqrt(denom)
            u = g32.div_(denom)
            del denom
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            # p - lr·u, as -(lr·u) + p: the same rounding
            return u.mul_(-lr_t).add_(p).to(p.dtype), nf

        # a parameter leaf meets its factor dict: tree_map walks params
        out = tree_map(upd, params, grads, state.inner)
        return (tree_map(lambda o: o[0], out),
                OptState(step=t, inner=tree_map(lambda o: o[1], out)))

    return Optimizer(init=init, update=_spanned(update))
