"""Kernel dispatch policy for the compression hot path.

Every ``use_kernel`` argument on the hot path (``compress_for_edge``,
``boundary_compress``, ``ef_compress``, ``topk_mask``) accepts a policy,
resolved here by :func:`resolve_policy` against the tensor's device:

* ``False`` / ``None`` / ``"off"`` -> ``"global"`` — global top-k over the
  whole tensor (the default; no codec).
* ``"auto"`` -> ``"cuda"`` (the hand-written kernels) for a CUDA tensor,
  ``"plain"`` (their plain PyTorch versions) for a CPU tensor.  Both have
  the same tie-capped blockwise selection, bit for bit.
* ``True`` / ``"force"`` -> ``"cuda"``; a CPU tensor raises (the port has no
  interpret mode).

The choice follows the tensor's device, never whether a build succeeded: a
CUDA tensor reaches the kernels or an error.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from . import ref as kref
from . import topk_compress as tk

Policy = Union[bool, str, None]

#: policy values accepted by ``resolve_policy``
POLICIES = (False, True, None, "off", "auto", "force")

encode_topk = tk.encode_topk
decode_topk = tk.decode_topk


def resolve_policy(policy: Policy, device: torch.device) -> str:
    """Map a ``use_kernel`` policy to an execution mode for a tensor on
    ``device``: ``"global"``, ``"plain"`` or ``"cuda"``."""
    if policy is None or policy is False or policy == "off":
        return "global"
    on_cuda = torch.device(device).type == "cuda"
    if policy is True or policy == "force":
        if not on_cuda:
            raise ValueError(
                f"use_kernel={policy!r} needs a CUDA tensor, got one on "
                f"{device}; the CUDA kernels have no CPU mode")
        return "cuda"
    if policy == "auto":
        return "cuda" if on_cuda else "plain"
    raise ValueError(
        f"unknown kernel dispatch policy {policy!r}; expected one of "
        f"{POLICIES}")


def per_block_k(n: int, k: int, block: int = tk.DEFAULT_BLOCK) -> int:
    """Global k -> per-block k (ceil split over the tile grid)."""
    nb = -(-int(n) // block)
    return max(1, -(-int(k) // nb))


def codec_topk_mask(x: torch.Tensor, k: int, mode: str,
                    block: int = tk.DEFAULT_BLOCK) -> torch.Tensor:
    """Wire-faithful sparsification: encode (threshold search + bitmap +
    packed-value compaction) then decode — the consumer sees exactly what
    the "mask" wire encoding carried.  ``mode`` is a resolved policy; the
    wrappers pick kernel or plain version by ``x``'s device."""
    if mode == "cuda" and x.device.type != "cuda":
        raise ValueError(f"mode 'cuda' on a tensor on {x.device}")
    kpb = per_block_k(x.numel(), k, block)
    values, bitmap = tk.encode_topk(x, kpb, block)
    return tk.decode_topk(values, bitmap, tuple(x.shape))


def codec_ef_topk(x: torch.Tensor, residual: torch.Tensor, k: int, mode: str,
                  block: int = tk.DEFAULT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback codec round trip: (sent, new_residual).  Its fused
    kernel, ``ef_encode_topk``, is not ported yet: a CUDA tensor raises."""
    if mode == "cuda" or x.device.type == "cuda":
        raise NotImplementedError(
            "the error-feedback codec kernel ef_encode_topk is not ported to "
            "CUDA yet; use use_kernel='off' for error feedback on the card")
    kpb = per_block_k(x.numel(), k, block)
    values, bitmap, newr = kref.ef_encode_topk_ref(x, residual, kpb, block)
    return kref.decode_topk_ref(values, bitmap, tuple(x.shape)), newr
