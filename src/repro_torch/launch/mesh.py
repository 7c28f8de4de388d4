"""Mesh definitions: the port's ``jax.make_mesh`` and the meshes the JAX
package's launchers build.

Functions, never module-level constants, so importing this module touches
no device.
"""
from __future__ import annotations

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
    on the CPU.  Without a card the default raises, like every entry
    point."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = [dev]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh((len(devices), 1), ("data", "model"), devices)
