"""Scan over stacked layers, as a Python loop.

The JAX package scans each segment's blocks with ``jax.lax.scan`` over
parameters stacked on a leading axis, and ``set_unroll`` switches the
scans to unrolled for exact cost analysis.  PyTorch runs eagerly, so here
the scan is a plain loop and ``set_unroll`` is kept only so callers written
against the JAX package run unchanged: it changes nothing.

Each stacked leaf is split once with ``torch.unbind``: autograd's backward
of ``leaf[i]`` builds a zero tensor the size of the whole stacked leaf for
every layer, while ``unbind``'s backward stacks the layers' gradients once.
A DTensor leaf sharded over its stacked axis (a stacked ``(L, d)`` norm
scale, whose second to last axis the sharding rules put on ``data``) is
gathered on that axis first, as XLA gathers a scan's sharded operand.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch

from repro_torch.distributed.sharding import is_dtensor


def unstack(tree: Any) -> List[Any]:
    """A tree whose leaves are stacked on axis 0 -> a list of per-layer
    trees (one ``torch.unbind`` for each leaf)."""
    if isinstance(tree, Mapping):
        keys = list(tree)
        parts = [unstack(tree[k]) for k in keys]
        return [dict(zip(keys, layer)) for layer in zip(*parts)]
    return list(torch.unbind(_gather_axis0(tree), 0))


def _gather_axis0(t: torch.Tensor) -> torch.Tensor:
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    placements = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                  for p in t.placements]
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def scan(body: Callable[[Any, Any], Tuple[Any, Any]], init: Any, xs: Any,
         **_kw) -> Tuple[Any, Optional[List[Any]]]:
    """``jax.lax.scan`` semantics over the stacked leading axis of ``xs``:
    returns the final carry and the list of per-step outputs (``None`` when
    every step returned ``None``)."""
    carry, ys = init, []
    for x in unstack(xs):
        carry, y = body(carry, x)
        ys.append(y)
    return carry, (None if all(y is None for y in ys) else ys)


@contextlib.contextmanager
def set_unroll(n):
    """Kept for the JAX package's callers; an eager loop has nothing to
    unroll."""
    del n
    yield
