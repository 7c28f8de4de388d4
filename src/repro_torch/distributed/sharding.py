"""Sharding vocabulary: meshes, partition specs and logical-axis rules.

The JAX package takes ``Mesh``, ``NamedSharding`` and ``PartitionSpec`` from
``jax.sharding``; the port keeps its own:

* :class:`Mesh` — a grid of devices with named axes (``shape`` an ordered
  mapping, ``axis_names``, ``size``, ``devices`` an array of
  ``torch.device`` or ``None`` for a mesh that only describes a layout),
  and on a *process mesh* the ``torch.distributed`` ``DeviceMesh`` whose
  positions are the ranks of a process group (``device_mesh``);
* :class:`PartitionSpec` (``P``) — a tuple with JAX's equality: an entry
  that is a one-axis tuple equals its scalar form, and an empty tuple
  equals ``None``;
* :class:`NamedSharding` — a mesh and a spec, the shape of one shard, and
  on a process mesh its DTensor ``placements``.

Model code annotates activations with *logical* axes (``"batch"``,
``"model"``, ``"seq"``); :func:`use_mesh` binds them to physical mesh axes.
Off-mesh, on one device, or when every axis resolves to ``None``,
:func:`constrain` is the identity, as in JAX.  On a process mesh it
redistributes a DTensor to the spec's placements (JAX's
``with_sharding_constraint``); on a mesh of devices in one process there is
no partitioner to hand the constraint to, and it raises.
"""
from __future__ import annotations

import collections
import contextlib
import math
import sys
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Rules = Dict[str, Union[str, Tuple[str, ...], None]]


# =================================================================== mesh ==
class Mesh:
    """Devices on a grid with named axes.  ``devices`` holds one
    ``torch.device`` per position (a device may repeat) or is ``None``.

    With ``device_mesh`` (a ``torch.distributed`` ``DeviceMesh`` of the same
    shape and axis names) it is a process mesh: position r is rank r,
    row-major, as JAX's ``mesh.devices.flat``, and ``devices`` holds each
    rank's device."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None,
                 device_mesh=None):
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
        self.device_mesh = device_mesh
        if device_mesh is not None and (
                tuple(device_mesh.shape) != shape
                or tuple(device_mesh.mesh_dim_names or ()) != axis_names):
            raise ValueError(f"device mesh {device_mesh} is not {shape} "
                             f"over {axis_names}")

    @property
    def is_process_mesh(self) -> bool:
        return self.device_mesh is not None

    def coordinate(self) -> Dict[str, int]:
        """This rank's position on a process mesh, by axis."""
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in the order of first position."""
        if self.devices is None:
            return ()
        return tuple(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        where = "no devices" if self.devices is None else \
            f"on {', '.join(map(str, self.distinct_devices()))}"
        if self.is_process_mesh:
            where += f", {self.size} ranks"
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

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` on each axis
        that spec entry ``d`` names (a tuple entry shards its dimension on
        each of its axes, major first, as in JAX), ``Replicate()`` on an
        axis no entry names.  A tuple whose axes run against the mesh's
        order would need another shard order than DTensor's default; it
        raises."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.axis_names)
        order = {a: i for i, a in enumerate(self.mesh.axis_names)}
        for d, part in enumerate(self.spec):
            idx = [order[a] for a in _axes(part)]
            if idx != sorted(idx):
                raise NotImplementedError(
                    f"{self.spec} shards dim {d} over {part} against the "
                    f"mesh's axis order {self.mesh.axis_names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def local_slices(self, global_shape: Sequence[int],
                     coordinate: Dict[str, int]) -> Tuple[slice, ...]:
        """The index of the shard at mesh ``coordinate`` (axis -> position)
        into an array of ``global_shape``: JAX's
        ``devices_indices_map`` entry for that position."""
        local = self.shard_shape(global_shape)
        out = [slice(None)] * len(local)
        for d, part in enumerate(self.spec):
            idx = 0
            for a in _axes(part):
                idx = idx * self.mesh.shape[a] + coordinate[a]
            if _axes(part):
                out[d] = slice(idx * local[d], (idx + 1) * local[d])
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
    to ``None`` (as in JAX, where an all-None spec would pin replication).
    On a process mesh a DTensor is redistributed to the spec's placements
    and a plain tensor raises ``TypeError`` (it would be computed whole on
    every rank); on a mesh of devices in one process it raises
    ``NotImplementedError``: there is no partitioner to hand the
    constraint to."""
    mesh, _ = _current()
    if mesh is None or mesh.size == 1:
        return x
    if x.dim() != len(axes):
        raise ValueError(f"rank {x.dim()} vs axes {axes}")
    if mesh.is_process_mesh and not is_dtensor(x):
        raise TypeError(f"constrain on {mesh!r}: a plain tensor of shape "
                        f"{tuple(x.shape)}, not a DTensor")
    spec = logical_to_spec(axes)
    if all(s is None for s in spec):
        return x
    if mesh.is_process_mesh:
        return place(x, NamedSharding(mesh, spec))
    raise NotImplementedError(
        f"constrain to {spec} on {mesh!r}: the port places no shards on a "
        f"mesh of devices in one process")


# ============================================================== DTensors ==
def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor, ~1 s, where
    nothing has: then no tensor can be one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_of(x) -> Optional[Mesh]:
    """The process mesh a DTensor lives on (``None`` for a plain tensor)."""
    if not is_dtensor(x):
        return None
    dm = x.device_mesh
    return Mesh(dm.shape, dm.mesh_dim_names, [x.device] * dm.size(),
                device_mesh=dm)


def place(x, sharding: NamedSharding):
    """A DTensor redistributed to ``sharding``'s placements (unchanged when
    it is there already)."""
    placements = sharding.placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(sharding.mesh.device_mesh, placements)


def from_local(local: torch.Tensor, sharding: NamedSharding,
               global_shape: Sequence[int]):
    """This rank's shard ``local`` of a tensor of ``global_shape``, as a
    DTensor placed by ``sharding`` on its process mesh."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(d) for d in global_shape)
    if tuple(local.shape) != sharding.shard_shape(shape):
        raise ValueError(f"a shard of {tuple(local.shape)} for {shape} "
                         f"placed by {sharding.spec}")
    return DTensor.from_local(local.contiguous(),
                              sharding.mesh.device_mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=_contiguous(shape))


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """This rank's shard of the whole tensor ``t``, which every rank holds
    alike, as a DTensor placed by ``sharding`` on its process mesh: a local
    slice, no communication."""
    local = t[sharding.local_slices(t.shape, sharding.mesh.coordinate())]
    return from_local(local, sharding, t.shape)


def zeros(shape: Sequence[int], dtype: torch.dtype,
          sharding: NamedSharding):
    """Zeros of ``shape`` placed by ``sharding`` on its process mesh: each
    rank allocates its shard only."""
    local = torch.zeros(sharding.shard_shape(shape), dtype=dtype,
                        device=sharding.mesh.devices.flat[0])
    return from_local(local, sharding, shape)


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` as ``ref`` takes it: unchanged beside a plain tensor; beside a
    DTensor, replicated on its mesh (``t`` is a constant every rank
    computes alike, such as positions or a mask)."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    dm = ref.device_mesh
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


def on_shards(fn, out_placements, *args, in_grad_placements=None):
    """``fn`` on each rank's local shards of the DTensor ``args`` (taken as
    placed; a non-tensor argument passes through), its results wrapped as
    DTensors with ``out_placements`` (one sequence, or one per result):
    ``local_map`` with the placements stated.  ``in_grad_placements``
    (one per argument; ``None`` for an argument's own placements) says how
    the local gradients add up: ``Partial`` on an axis where each rank's
    gradient covers only its share of the work."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)       # one result
    else:
        out_placements = tuple(list(p) for p in out_placements)
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None
                  for a in args)
    if in_grad_placements is not None:
        in_grad_placements = tuple(
            g if g is not None else p
            for g, p in zip(in_grad_placements, in_pl))
    return local_map(fn, out_placements=out_placements, in_placements=in_pl,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh)(*args)


def rows_and_heads(t: torch.Tensor, head_dim: int) -> Tuple[Optional[str],
                                                            ...]:
    """What each mesh axis shards of the DTensor ``t``: ``"rows"`` (its
    batch, dimension 0), ``"heads"`` (dimension ``head_dim``) or nothing
    (``None``)."""
    from torch.distributed.tensor import Shard
    return tuple("rows" if pl == Shard(0) else
                 "heads" if pl == Shard(head_dim) else None
                 for pl in t.placements)


def rows_and_heads_of(device_mesh, batch: int, heads: Optional[int]
                      ) -> Tuple[Optional[str], ...]:
    """:func:`rows_and_heads` by the current rules: the mesh axes of the
    logical ``"batch"`` shard the rows where they divide ``batch``, the
    axis of ``"heads"`` shards the heads where it divides ``heads`` (no
    axis does for ``None``), and the others shard nothing."""
    _, rules = _current()
    batch_axes, head_axes = _axes(rules.get("batch")), _axes(
        rules.get("heads"))
    out, rows = [], 1
    for name, size in zip(device_mesh.mesh_dim_names, device_mesh.shape):
        if name in batch_axes and batch % (rows * size) == 0:
            rows *= size
            out.append("rows")
        elif name in head_axes and heads is not None and heads % size == 0:
            out.append("heads")
        else:
            out.append(None)
    return tuple(out)


def settled(t: torch.Tensor) -> torch.Tensor:
    """The DTensor ``t`` with its ``Partial`` placements summed
    (``Replicate``): the backward of a redistribution from ``Partial``
    straight to ``Shard`` would go from ``Shard`` to ``Partial``, which
    DTensor in torch 2.11 does not support (from ``Replicate`` it keeps
    the gradient replicated)."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def pinned(t: torch.Tensor) -> torch.Tensor:
    """The DTensor ``t`` as it is, with the gradient of this use of it
    delivered in ``t``'s own placements (an identity ``on_shards``).
    Autograd leaves a gradient where the backward put it, often
    ``Partial``; where two uses of a tensor meet in its backward, DTensor
    in torch 2.11 may then add a ``Partial`` gradient to a sharded one by
    redistributing the sharded one to ``Partial``, which it cannot."""
    return on_shards(lambda a: a, list(t.placements), t)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` with every shard of a middle dimension (the
    sequence of a (batch, sequence, features) activation, which the
    ``act_seq`` rule shards) gathered, before ``x`` meets a matmul:
    Megatron's sequence parallelism all-gathers there too.  DTensor in
    torch 2.11 cannot flatten a sharded middle dimension into a matmul's
    rows ("Attempted to flatten multiple dimensions").  A plain tensor, or
    a DTensor with no such shard, passes through."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate
    placements = [Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1
                  else p for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def scatter_sequence(y: torch.Tensor) -> torch.Tensor:
    """The DTensor ``y`` (a matmul's (batch, sequence, features) output)
    with each partial sum on a mesh axis that the ``act_seq`` rule names
    reduced straight onto that axis's slice of the sequence: Megatron's
    reduce-scatter after a row-parallel matmul, where the residual stream
    is sequence-sharded.  Left to the residual's add, DTensor would
    reduce-scatter inside the add, whose backward then hands the matmul a
    sequence-sharded gradient that DTensor in torch 2.11 cannot flatten
    into the matmul's rows.  Anything else passes through."""
    if not is_dtensor(y) or y.dim() < 3:
        return y
    from torch.distributed.tensor import Shard
    seq = _axes(_current()[1].get("act_seq"))
    placements = [Shard(1) if p.is_partial() and name in seq else p
                  for name, p in zip(y.device_mesh.mesh_dim_names,
                                     y.placements)]
    if placements == list(y.placements):
        return y
    return y.redistribute(y.device_mesh, placements)


def on_rows_and_heads(fn, axes, args, specs, out_specs):
    """``fn(*args)`` on each rank's batch rows and heads, as
    :func:`rows_and_heads` names the mesh axes.  ``specs`` (one per
    argument) and ``out_specs`` (one per result; ``fn`` returns a tuple
    of several, or one tensor) are (whether dimension 0 is the batch, the
    heads' dimension or ``None``); every DTensor
    argument is placed so, and ``None`` passes through.  A rank's gradient
    of an argument without rows (a weight) covers only its rows, and of
    one without heads only its heads: ``Partial`` on that axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def placed(rows, head):
        return [Shard(0) if a == "rows" and rows else
                Shard(head) if a == "heads" and head is not None else
                Replicate() for a in axes]

    def grad(rows, head):
        return [Partial() if (a == "rows" and not rows)
                or (a == "heads" and head is None) else pl
                for a, pl in zip(axes, placed(rows, head))]
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    args = [a if a is None else settled(a).redistribute(mesh, placed(*sp))
            for a, sp in zip(args, specs)]
    outs = [placed(*sp) for sp in out_specs]
    return on_shards(fn, outs[0] if len(outs) == 1 else tuple(outs), *args,
                     in_grad_placements=[None if a is None else grad(*sp)
                                         for a, sp in zip(args, specs)])


def local_offset(global_shape: Sequence[int], device_mesh, placements,
                 dim: int) -> Tuple[int, int]:
    """(start, length) along ``dim`` of this rank's shard of a tensor of
    ``global_shape`` placed by ``placements`` on ``device_mesh``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        tuple(global_shape), device_mesh, placements)
    return int(offset[dim]), int(shape[dim])


def _contiguous(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(d)
    return tuple(reversed(out))


def named_sharding(mesh: Mesh, *axes: Optional[str]) -> NamedSharding:
    with use_mesh(mesh):
        return NamedSharding(mesh, logical_to_spec(axes))
