"""Parameter / optimizer-state sharding rules.

Generic 2D rule (FSDP × TP, MaxText-style "fsdp+tensor"):
* last dim  -> ``model`` axis when divisible (output features / experts' ff)
* 2nd-last  -> ``data``  axis when divisible (input features; ZeRO-3-like)
* everything else replicated; the ``pod`` axis never shards weights
  (DP across pods — the paper's geo-hierarchy maps compression, not weight
  sharding, onto the slow axis).

Per-path overrides change individual tensors without touching model code.
A tree here is the port's: nested dicts (key paths as in the JAX package's
pytrees), lists and tuples (by index) and named tuples such as
``OptState`` (by field name), with tensors — ``meta`` ones included — at
the leaves.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from .sharding import (Mesh, NamedSharding, PartitionSpec as P,
                       distribute, is_dtensor, place)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def generic_spec(shape: Tuple[int, ...], mesh: Mesh,
                 model_axis: str = "model", data_axis: str = "data") -> P:
    msz = _axis_size(mesh, model_axis)
    dsz = _axis_size(mesh, data_axis)
    spec = [None] * len(shape)
    if len(shape) >= 1 and msz > 1 and shape[-1] % msz == 0 \
            and shape[-1] >= msz:
        spec[-1] = model_axis
    if len(shape) >= 2 and dsz > 1 and shape[-2] % dsz == 0 \
            and shape[-2] >= dsz:
        spec[-2] = data_axis
    return P(*spec)


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree: Any,
                       path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree; ``path`` is the tuple of dict keys,
    field names and indices from the root, as ``jax.tree_util`` gives.
    ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_zip_map(fn: Callable[[Any, Any], Any], tree: Any,
                 other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of the same structure (the
    first one's); ``None`` in ``tree`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_zip_map(fn, a, b)
                            for a, b in zip(tree, other)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_zip_map(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Whole tensors, alike on every rank, -> this rank's shards as
    DTensors placed by ``shardings`` (a local slice each, no
    communication)."""
    return tree_zip_map(distribute, tree, shardings)


def place_tree(tree: Any, shardings: Any) -> Any:
    """Every DTensor leaf redistributed to its sharding, as ``jax.jit``'s
    in/out shardings place a step's arguments and results; a plain tensor
    raises (it is not on the mesh)."""
    def one(x, sh):
        if not is_dtensor(x):
            raise TypeError(f"a plain tensor of shape {tuple(x.shape)} "
                            f"where a DTensor placed by {sh.spec} belongs")
        return place(x, sh)
    return tree_zip_map(one, tree, shardings)


def tree_path_str(path) -> str:
    return "/".join(str(p) for p in path)


def row_spec(shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Row-parallel (Megatron): contraction dim (−2) on ``model`` so the
    matmul psums activation partials instead of all-gathering the full
    activation; output features (−1) FSDP-shard on ``data``."""
    msz = _axis_size(mesh, "model")
    dsz = _axis_size(mesh, "data")
    spec = [None] * len(shape)
    if len(shape) >= 2 and msz > 1 and shape[-2] % msz == 0 \
            and shape[-2] >= msz:
        spec[-2] = "model"
    if len(shape) >= 1 and dsz > 1 and shape[-1] % dsz == 0 \
            and shape[-1] >= dsz:
        spec[-1] = "data"
    return P(*spec)


# Projections whose *input* features carry the model-sharded activation:
# attention output, MLP down, Mamba out, mLSTM down, sLSTM FFN down, MoE down.
ROW_PARALLEL_PATTERNS = (
    r".*/(?:wo|out_proj|ffn_down|down)/w",
    r".*/moe/down",
    r".*/shared/down/w",
)


def param_shardings(tree: Any, mesh: Mesh,
                    overrides: Optional[Dict[str, P]] = None,
                    rule: Callable = generic_spec) -> Any:
    """Tensor tree -> NamedSharding tree.

    ``overrides``: regex (fullmatch on '/'-joined path) -> PartitionSpec,
    applied before the row-parallel defaults and the generic rule.
    """
    overrides = overrides or {}
    compiled = [(re.compile(k), v) for k, v in overrides.items()]
    rows = [re.compile(p) for p in ROW_PARALLEL_PATTERNS]

    def assign(path, leaf):
        pstr = tree_path_str(path)
        for rx, spec in compiled:
            if rx.fullmatch(pstr):
                return NamedSharding(mesh, spec)
        for rx in rows:
            if rx.fullmatch(pstr):
                return NamedSharding(mesh, row_spec(tuple(leaf.shape), mesh))
        return NamedSharding(mesh, rule(tuple(leaf.shape), mesh))

    return tree_map_with_path(assign, tree)


def replicated(tree: Any, mesh: Mesh) -> Any:
    return tree_map_with_path(lambda _, __: NamedSharding(mesh, P()), tree)


def batch_spec(global_batch: int, mesh: Mesh) -> P:
    """Shard the batch over ('pod','data') when divisible, else 'data',
    else replicate (long_500k has batch=1)."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if axes and global_batch % size == 0 and global_batch >= size:
        # single axis: scalar form, so the spec compares equal to P("data")
        return P(axes[0] if len(axes) == 1 else tuple(axes))
    if "data" in mesh.axis_names and global_batch % mesh.shape["data"] == 0 \
            and global_batch >= mesh.shape["data"]:
        return P("data")
    return P(None)
