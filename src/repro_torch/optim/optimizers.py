"""Optimizers as functional transforms over nested dicts of tensors.

Each optimizer is an (init, update) pair packaged in :class:`Optimizer`;
state and params are nested dicts with the parameters' key paths, so the
same code drives the FusionLLM decentralized runtime (per-CompNode
sub-trees — the paper's per-OP "Update" stage, §3.3) and unit tests.  The
update is written out (no ``torch.optim``) so it is the JAX package's
formula: ``update`` returns new tensors and leaves its inputs as they were.

Schedules map the step (a 0-dim int tensor) to a 0-dim float32 tensor on
the CPU, which scales tensors on any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.opgraph import tree_leaves
from repro_torch.core.rad import tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], Tuple[Any, OptState]]
    # update(grads, state, params) -> (new_params, new_state)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


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
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


# -------------------------------------------------------------------- SGD --
def sgd(lr=1e-2, momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(step=torch.zeros((), dtype=torch.int32), inner=mom)

    def update(grads, state, params):
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

    return Optimizer(init=init, update=update)


# ------------------------------------------------------------------ AdamW --
def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        inner={"m": tree_map(zeros, params),
                               "v": tree_map(zeros, params)})

    def update(grads, state, params):
        t = state.step + 1
        lr_t = sched(state.step)
        bc1 = 1 - _f32(b1) ** _f32(t)
        bc2 = 1 - _f32(b2) ** _f32(t)

        def leaf(p, g, m_, v_):
            g32 = g.to(torch.float32)
            m = b1 * m_ + (1 - b1) * g32
            v = b2 * v_ + (1 - b2) * torch.square(g32)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            new_p = (p - lr_t * (upd + weight_decay * p.to(torch.float32))
                     ).to(p.dtype)
            return new_p, m, v

        out = tree_map(leaf, params, grads, state.inner["m"],
                       state.inner["v"])
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), OptState(step=t, inner={"m": pick(1), "v": pick(2)})

    return Optimizer(init=init, update=update)
