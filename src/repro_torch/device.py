"""Device selection for the port's entry points.

Entry points default to ``"cuda"``; a missing card is an error, never a
silent move to the CPU.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Validate ``device`` and pin the card's fp32 numerics.

    A CUDA device without ``torch.cuda.is_available()`` raises.  On CUDA,
    TF32 is switched off for matmuls and cuDNN so float32 means float32, as
    in the JAX reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev
