"""Entry points over the Top-K kernels, plus the kernel dispatch policy of
the compression hot path.

``topk_mask(x, k)`` takes a global k, as
:func:`repro_torch.core.compression.topk_mask` does, and splits it into a
per-block k (ceil split) for the dense blockwise kernel.  The codec's two
halves, :func:`codec_encode` on the sender and :func:`codec_decode` on the
receiver, compose to :func:`codec_topk_mask`; the pipeline sends the wire
between them when a stage boundary crosses processes.  The entry points
here take the kernel for a CUDA tensor and its plain version for a CPU
tensor (the wrappers in :mod:`repro_torch.kernels.topk_compress` decide by
device).

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

from . import topk_compress as tk

Policy = Union[bool, str, None]

#: policy values accepted by ``resolve_policy``
POLICIES = (False, True, None, "off", "auto", "force")

encode_topk = tk.encode_topk
decode_topk = tk.decode_topk
ef_encode_topk = tk.ef_encode_topk
blockwise_topk_mask = tk.blockwise_topk_mask
ef_topk = tk.ef_topk


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


def topk_mask(x: torch.Tensor, k: int,
              block: int = tk.DEFAULT_BLOCK) -> torch.Tensor:
    """Global-k API -> per-block k (keeps ~k total, exact per block)."""
    return tk.blockwise_topk_mask(x, per_block_k(x.numel(), k, block), block)


def _check_mode(x: torch.Tensor, mode: str) -> None:
    if mode == "cuda" and not x.is_cuda:
        raise ValueError(f"mode 'cuda' on a tensor on {x.device}")


def codec_wire_shapes(n: int, k: int, block: int = tk.DEFAULT_BLOCK
                      ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The shapes of the wire :func:`codec_encode` makes of a tensor of
    ``n`` entries at global ``k``: values ``(nb, k a block)`` in the
    tensor's dtype and bitmap ``(nb, block / 32)`` int32 words.  A
    receiver sizes its buffers by them, from k and the static shape."""
    nb = -(-int(n) // block)
    return (nb, min(per_block_k(n, k, block), block)), (nb, block >> 5)


def codec_encode(x: torch.Tensor, k: int, mode: str,
                 block: int = tk.DEFAULT_BLOCK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sender's half of the codec: ``(values, bitmap)``, the wire of
    ``x`` at global ``k`` (split per block).  ``mode`` is a resolved
    policy; the wrapper picks kernel or plain version by ``x``'s
    device."""
    _check_mode(x, mode)
    return tk.encode_topk(x, per_block_k(x.numel(), k, block), block)


def codec_decode(values: torch.Tensor, bitmap: torch.Tensor,
                 shape: Tuple[int, ...], mode: str) -> torch.Tensor:
    """The receiver's half: the dense tensor of ``shape`` that the wire
    ``(values, bitmap)`` carries."""
    _check_mode(values, mode)
    return tk.decode_topk(values, bitmap, shape)


def codec_topk_mask(x: torch.Tensor, k: int, mode: str,
                    block: int = tk.DEFAULT_BLOCK) -> torch.Tensor:
    """Wire-faithful sparsification: encode (threshold search + bitmap +
    packed-value compaction) then decode — the consumer sees exactly what
    the "mask" wire encoding carried.  ``mode`` is a resolved policy; the
    wrappers pick kernel or plain version by ``x``'s device."""
    values, bitmap = codec_encode(x, k, mode, block)
    return codec_decode(values, bitmap, x.shape, mode)


def codec_ef_topk(x: torch.Tensor, residual: torch.Tensor, k: int, mode: str,
                  block: int = tk.DEFAULT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback codec round trip: (sent, new_residual), the residual
    update fused into the encode (``ef_encode_topk``), then the decode."""
    _check_mode(x, mode)
    kpb = per_block_k(x.numel(), k, block)
    values, bitmap, newr = tk.ef_encode_topk(x, residual, kpb, block)
    return tk.decode_topk(values, bitmap, x.shape), newr
