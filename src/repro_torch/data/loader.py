"""Device feeding: host numpy batches -> tensors on the training device.

The JAX package's ``ShardedLoader`` lays each batch out per the step's
input shardings.  On one card that is a copy to the device, so here the
loader takes the device: each integer array arrives as a ``torch.long``
tensor (the index dtype of ``embed`` and ``cross_entropy``), a floating one
(the enc-dec's ``src_embeds``) in its own dtype, through pinned host
memory and a non-blocking copy when the device is a card.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike


class ShardedLoader:
    def __init__(self, batch_iter: Iterator[Dict[str, np.ndarray]],
                 device: DeviceLike):
        self._it = batch_iter
        self._device = torch.device(device)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        host = next(self._it)
        cuda = self._device.type == "cuda"
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point():
                t = t.to(torch.long)
            if cuda:
                t = t.pin_memory()
            out[k] = t.to(self._device, non_blocking=cuda)
        return out
