"""Mesh definitions: the port's ``jax.make_mesh`` and the meshes the JAX
package's launchers build.

Two kinds of mesh: :func:`make_mesh` lays devices out in one process (a
device may repeat); :func:`make_process_mesh` lays out the ranks of an
initialised ``torch.distributed`` process group, on which the gspmd step
runs sharded with DTensor.

Functions, never module-level constants, so importing this module touches
no device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import Mesh


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Sequence[DeviceLike]) -> Mesh:
    """A mesh over an explicit list of ``prod(shape)`` devices, laid out in
    row-major order.  A device may repeat: eight positions on one card are
    what JAX's eight forced host devices are on one CPU."""
    return Mesh(shape, axis_names, devices)


def make_process_mesh(shape: Sequence[int], axis_names: Sequence[str],
                      device: DeviceLike) -> Mesh:
    """A mesh over the ranks of the initialised process group: rank r is
    position r, row-major, as in JAX's ``mesh.devices.flat``.  ``device``
    is this rank's device (several ranks may share one card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs an initialised process "
                           "group (repro_torch.launch.spmd starts one)")
    shape, axis_names = tuple(shape), tuple(axis_names)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh over {world} ranks")
    dev = torch.device(device)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    return Mesh(shape, axis_names, [dev] * world, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production layout: 16 × 16 = 256 chips a pod
    (``("data", "model")``); the multi-pod variant adds a leading pod axis
    (2 × 256 = 512).  A mesh with no devices (``devices is None``): no host
    here has 256 cards, so it describes shardings and places nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_local_mesh(device: DeviceLike = "cuda") -> Mesh:
    """``(n, 1)`` over ``("data", "model")`` for the n cards
    ``torch.cuda.device_count()`` sees; ``device="cpu"`` gives ``(1, 1)``
    on the CPU.  Inside an initialised process group it is the process
    mesh ``(world, 1)`` with ``device`` on this rank, as JAX's is over all
    its devices.  Without a card the default raises, like every entry
    point."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_initialized():
        return make_process_mesh((dist.get_world_size(), 1),
                                 ("data", "model"), dev)
    if dev.type == "cpu":
        devices = [dev]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh((len(devices), 1), ("data", "model"), devices)
