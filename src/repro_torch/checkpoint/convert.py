"""Parameters across frameworks: nested dicts of numpy arrays <-> tensors.

The JAX package's parameters are nested dicts of arrays; ``np.asarray`` of
each leaf gives the numpy tree these functions take.  Both sides keep the
same key paths, so the two packages can compute on the same weights.
bfloat16 travels as its raw 16 bits (numpy has no bfloat16 of its own).
On a process mesh each rank keeps its shard of the same numpy weights
(``shardings``), and the way back gathers every DTensor whole.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..distributed.sharding import from_local, is_dtensor


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def from_numpy_tree(tree: Mapping[str, Any], device: DeviceLike,
                    shardings: Optional[Mapping[str, Any]] = None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``;
    with ``shardings`` (a tree of ``NamedSharding`` over a process mesh)
    each leaf becomes this rank's shard, a DTensor (every rank passes the
    same arrays; only the shard is copied to ``device``)."""
    dev = torch.device(device)
    if shardings is not None:
        return {k: from_numpy_tree(v, dev, shardings[k])
                if isinstance(v, Mapping) else _shard(v, dev, shardings[k])
                for k, v in tree.items()}
    return {k: from_numpy_tree(v, dev) if isinstance(v, Mapping)
            else _to_tensor(v, dev) for k, v in tree.items()}


def _shard(a: Any, device: torch.device, sharding) -> torch.Tensor:
    arr = np.asarray(a)
    local = arr[sharding.local_slices(arr.shape, sharding.mesh.coordinate())]
    return from_local(_to_tensor(local, device), sharding, arr.shape)


def to_numpy_tree(params: Mapping[str, Any]) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host.
    bfloat16 leaves come back as float32 (exact).  A DTensor is gathered
    whole first (a collective: every rank of its mesh must call this)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = to_numpy_tree(v)
        else:
            if is_dtensor(v):
                v = v.full_tensor()
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            out[k] = t.numpy()
    return out
