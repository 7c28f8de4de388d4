"""State checkpointing: flattened-path .npz + JSON metadata.

The same layout as the JAX package's checkpoints, so a file or an in-memory
blob written by either package loads in the other bit for bit:

* one ``.npy`` member per leaf, named by its path in the tree: dict keys in
  sorted order, a named tuple's fields as ``.field`` (the optimizer state's
  ``.step`` and ``.inner``), list items as ``[i]``, joined by ``/`` and
  prefixed ``params/`` or ``opt/`` — e.g. ``params/a/w``, ``opt/.step``,
  ``opt/.inner/m/a/w``;
* bfloat16 and fp8 leaves are stored as float32 (exact) and cast back to
  the template leaf's dtype on load; every other dtype is stored as is
  (the optimizer step is int32 with shape ``()``).

Loading takes the structure, dtype and device of each leaf from a template
tree, so a state restored for tensors on the card lands on the card.
Members are written one leaf at a time, so a save holds one host copy of
one leaf beside the file or blob, never a second copy of the whole state.
"""
from __future__ import annotations

import io
import json
import os
import re
import zipfile
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_WIDENED = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s flattening order."""
    if tree is None:
        return
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _WIDENED:
            t = t.to(torch.float32)    # .npz-portable; cast back on load
        return t.cpu().numpy()
    return np.asarray(leaf)


def _write_npz(file: Any, params: Any, opt_state: Any) -> None:
    """np.savez's layout (stored, zip64 members), written leaf by leaf."""
    trees = [("params", params)]
    if opt_state is not None:
        trees.append(("opt", opt_state))
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for prefix, tree in trees:
            for key, leaf in _flatten(tree):
                with zf.open(f"{prefix}/{key}.npy", "w",
                             force_zip64=True) as fid:
                    np.lib.format.write_array(fid, _to_numpy(leaf),
                                              allow_pickle=False)


def _restore(data: Any, template: Any, prefix: str) -> Any:
    """Rebuild ``template``'s structure from flattened-path arrays
    (shape-checked); each leaf takes the template leaf's dtype and device."""
    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), path + (f".{f}",))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (f"[{i}]",))
                              for i, v in enumerate(node))
        key = "/".join(path)
        arr = data[f"{prefix}/{key}"]
        ref = node if isinstance(node, torch.Tensor) \
            else torch.as_tensor(np.asarray(node))
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"ckpt leaf {key}: shape {arr.shape} vs "
                             f"template {tuple(ref.shape)}")
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
    return walk(template, ())


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _write_npz(path, params, opt_state)
    meta = dict(metadata or {})
    meta["step"] = step
    with open(path.replace(".npz", ".json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def load_checkpoint(path: str, params_template: Any,
                    opt_template: Any = None) -> Tuple[Any, Any, Dict]:
    """Restore into the structure of the provided templates (shape-checked)."""
    meta_path = path.replace(".npz", ".json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    with np.load(path) as data:
        params = _restore(data, params_template, "params")
        opt = _restore(data, opt_template, "opt") \
            if opt_template is not None else None
    return params, opt, meta


def serialize_state(params: Any, opt_state: Any = None) -> bytes:
    """Pack (params, opt_state) into .npz bytes — the same wire format as
    on-disk checkpoints, held in memory.  The elastic runtime ships migrated
    sub-trees between CompNodes in this envelope, so a migration exercises
    the identical flatten/cast path as a checkpoint round-trip (bit-exact,
    tested)."""
    buf = io.BytesIO()
    _write_npz(buf, params, opt_state)
    return buf.getvalue()


def deserialize_state(blob: bytes, params_template: Any,
                      opt_template: Any = None) -> Tuple[Any, Any]:
    """Inverse of :func:`serialize_state` (structure, dtypes and devices
    come from the templates)."""
    with np.load(io.BytesIO(blob)) as data:
        params = _restore(data, params_template, "params")
        opt = _restore(data, opt_template, "opt") \
            if opt_template is not None else None
    return params, opt


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for f in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, f), int(m.group(1))
    return best
