"""Sharding vocabulary: meshes, partition specs and logical-axis rules.

The JAX package takes ``Mesh``, ``NamedSharding`` and ``PartitionSpec`` from
``jax.sharding``; the port keeps its own:

* :class:`Mesh` — a grid of devices with named axes (``shape`` an ordered
  mapping, ``axis_names``, ``size``, ``devices`` an array of
  ``torch.device`` or ``None`` for a mesh that only describes a layout);
* :class:`PartitionSpec` (``P``) — a tuple with JAX's equality: an entry
  that is a one-axis tuple equals its scalar form, and an empty tuple
  equals ``None``;
* :class:`NamedSharding` — a mesh and a spec, and the shape of one shard.

Model code annotates activations with *logical* axes (``"batch"``,
``"model"``, ``"seq"``); :func:`use_mesh` binds them to physical mesh axes.
Off-mesh, on one device, or when every axis resolves to ``None``,
:func:`constrain` is the identity, as in JAX.  Anything else would need a
partitioner to hand the constraint to, and the port has none: it raises.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Rules = Dict[str, Union[str, Tuple[str, ...], None]]


# =================================================================== mesh ==
class Mesh:
    """Devices on a grid with named axes.  ``devices`` holds one
    ``torch.device`` per position (a device may repeat) or is ``None``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.size = math.prod(shape)
        self.devices = None
        if devices is not None:
            flat = [torch.device(d) for d in devices]
            if len(flat) != self.size:
                raise ValueError(f"{len(flat)} devices for a mesh of "
                                 f"{self.size} positions {shape}")
            arr = np.empty(self.size, dtype=object)
            arr[:] = flat
            self.devices = arr.reshape(shape)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in the order of first position."""
        if self.devices is None:
            return ()
        return tuple(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        where = "no devices" if self.devices is None else \
            f"on {', '.join(map(str, self.distinct_devices()))}"
        return f"Mesh({axes}; {where})"


# ====================================================== partition specs ==
def _canonical(part):
    if isinstance(part, (tuple, list)):
        if len(part) == 0:
            return None
        return part[0] if len(part) == 1 else tuple(part)
    return part


class PartitionSpec(tuple):
    """One entry per array dimension: ``None`` (replicated), a mesh axis,
    or a tuple of mesh axes.  ``P(("data",)) == P("data")``, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_canonical(p) for p in parts))

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return tuple(self) == tuple(_canonical(p) for p in other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a partition spec over its axes."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for part in self.spec:
            for axis in _axes(part):
                if axis not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {axis!r}, "
                                     f"not in mesh axes {mesh.axis_names}")

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one shard; a dimension its axes do not divide
        raises, as ``jax.sharding.NamedSharding.shard_shape`` does."""
        shape = tuple(int(d) for d in global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"rank of {shape}")
        out = list(shape)
        for i, part in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in _axes(part))
            if shape[i] % n:
                raise ValueError(f"{self} splits axis {i} of {shape} "
                                 f"{n} ways")
            out[i] = shape[i] // n
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


# ================================================================= rules ==
_state = threading.local()

# logical name -> physical mesh axis (or tuple of axes)
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "model": "model",
    "seq": None,
    "kvseq": "model",      # decode KV caches shard sequence over model axis
    "expert": "model",
    "vocab": "model",
    "ff": "model",
    "heads": "model",
    # --- perf-iteration levers (off in the baseline; perf/ flips them) ---
    "act_seq": None,       # Megatron sequence parallelism: residual-stream
                           # activations sharded over 'model' between blocks
    "expert_dispatch": None,  # expert-parallel (E,C,d) dispatch buffers
}


def _current() -> Tuple[Optional[Mesh], Rules]:
    return (getattr(_state, "mesh", None),
            getattr(_state, "rules", DEFAULT_RULES))


@contextlib.contextmanager
def use_mesh(mesh: Mesh, rules: Optional[Rules] = None):
    """Activate a mesh + logical-axis rules for model-internal constraints
    (per thread)."""
    prev = _current()
    _state.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)

    # drop axes the mesh does not have (e.g. "pod" on the single-pod mesh)
    def _filter(v):
        kept = tuple(a for a in _axes(v) if a in mesh.axis_names)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept
    _state.rules = {k: _filter(v) for k, v in merged.items()}
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def logical_to_spec(axes: Sequence[Optional[str]]) -> PartitionSpec:
    _, rules = _current()
    return P(*[rules.get(a) if a is not None else None for a in axes])


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` by logical axes.  The identity
    off-mesh, on a mesh of one device, or when every logical axis resolves
    to ``None`` (as in JAX, where an all-None spec would pin replication);
    otherwise ``NotImplementedError``: the port has no partitioner to hand
    the constraint to."""
    mesh, _ = _current()
    if mesh is None or mesh.size == 1:
        return x
    if x.dim() != len(axes):
        raise ValueError(f"rank {x.dim()} vs axes {axes}")
    spec = logical_to_spec(axes)
    if all(s is None for s in spec):
        return x
    raise NotImplementedError(
        f"constrain to {spec} on {mesh!r}: the port places no shards and "
        f"has no partitioner to hand a sharding constraint to")


def named_sharding(mesh: Mesh, *axes: Optional[str]) -> NamedSharding:
    with use_mesh(mesh):
        return NamedSharding(mesh, logical_to_spec(axes))
