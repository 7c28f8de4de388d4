"""Parameters across frameworks: nested dicts of numpy arrays <-> tensors.

The JAX package's parameters are nested dicts of arrays; ``np.asarray`` of
each leaf gives the numpy tree these functions take.  Both sides keep the
same key paths, so the two packages can compute on the same weights.
bfloat16 travels as its raw 16 bits (numpy has no bfloat16 of its own).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import DeviceLike


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def from_numpy_tree(tree: Mapping[str, Any],
                    device: DeviceLike) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = torch.device(device)
    return {k: from_numpy_tree(v, dev) if isinstance(v, Mapping)
            else _to_tensor(v, dev) for k, v in tree.items()}


def to_numpy_tree(params: Mapping[str, Any]) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host.
    bfloat16 leaves come back as float32 (exact)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = to_numpy_tree(v)
        else:
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            out[k] = t.numpy()
    return out
