"""Plain PyTorch versions of the Top-K kernels.

Each function here computes exactly what its kernel in
:mod:`repro_torch.kernels.topk_compress` computes, with ordinary tensor
ops.  The CPU path and the tests use them; on the card they are the
yardstick the CUDA kernels are held against, bit for bit.

Dense masks (``blockwise_topk_mask_ref``, ``ef_topk_ref``): per block of
``B`` elements keep every element whose ``|x|`` (as float32) is at least
the block's k-th largest magnitude.  Ties at the threshold make that a
*superset* of k elements, with no cap; the padding zeros of the last block
take part in selection (with a threshold of 0 they are kept, then trimmed).

Wire encode (tie-capped, fixed wire capacity): per block of ``B`` elements,
keep everything whose ``|x|`` (as float32) is strictly above the block's
k-th largest magnitude, plus the first ``k - n_above`` threshold ties in
index order — exactly ``min(k, B)`` slots per block.  The padding zeros of
the last block take part in selection.

Wire format: per block a bitmap of ``B/32`` 32-bit words, least
significant bit first, plus the ``k`` kept values in index order.  The
bitmap is held as an ``int32`` tensor carrying the uint32 words' bits
(``torch.uint32`` has no shifts on the CPU); ``.numpy().view(np.uint32)``
gives the words themselves.
"""
from __future__ import annotations

from typing import Tuple

import torch

CODEC_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def check_codec_dtype(x: torch.Tensor) -> None:
    if x.dtype not in CODEC_DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")


def topk_mask_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Global Top-K by magnitude, dense output (threshold semantics)."""
    flat = x.reshape(-1)
    k = int(min(max(k, 1), flat.shape[0]))
    mags = flat.abs().to(torch.float32)
    thr = torch.topk(mags, k, sorted=True).values[-1]
    return torch.where(mags >= thr, flat,
                       torch.zeros_like(flat)).reshape(x.shape)


def _pad_to_blocks(flat: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    n = flat.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, nb


def _tiles(x: torch.Tensor, block: int) -> torch.Tensor:
    if block % 32:
        raise ValueError(f"block must be a multiple of 32, got {block}")
    padded, nb = _pad_to_blocks(x.reshape(-1), block)
    return padded.reshape(nb, block)


def _mag_bits(tiles: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of |tiles| as float32 — in the same order as the
    magnitudes, since they are non-negative (what the kernel searches)."""
    return tiles.to(torch.float32).abs().view(torch.int32)


def _kth_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest bit pattern of each row, as a (rows, 1) value.  A
    value taken from a sort, so the sort's order among ties cannot change
    it."""
    return torch.sort(bits, dim=1, descending=True).values[:, k - 1:k]


def _keep_capped(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean keep-mask with exactly min(k, B) kept per row: everything
    strictly above the k-th largest bit pattern, plus the first
    ``k - n_above`` threshold ties in index order.

    The tie cap is a cumsum in index order.  ``torch.topk`` is not
    index-stable on ties, so it never picks the set."""
    thr = _kth_bits(bits, k)
    above = bits > thr
    n_above = above.sum(dim=1, keepdim=True, dtype=torch.int32)
    tie = bits == thr
    tie_rank = torch.cumsum(tie.to(torch.int32), dim=1)
    return above | (tie & (tie_rank <= (k - n_above)))


def blockwise_topk_mask_ref(x: torch.Tensor, k_per_block: int,
                            block: int = 4096) -> torch.Tensor:
    """Dense blockwise Top-K: each ``block``-sized tile of the flat tensor
    keeps every element with ``|x| >=`` its k-th largest magnitude (the tie
    superset), zeros elsewhere; trimmed back to ``x.shape``."""
    check_codec_dtype(x)
    tiles = _tiles(x, block)
    k = int(min(max(k_per_block, 1), block))
    bits = _mag_bits(tiles)
    out = torch.where(bits >= _kth_bits(bits, k), tiles,
                      tiles.new_zeros(()))
    return out.reshape(-1)[:x.numel()].reshape(x.shape)


def ef_topk_ref(x: torch.Tensor, residual: torch.Tensor, k_per_block: int,
                block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback dense Top-K: compress ``c = x + residual`` with
    :func:`blockwise_topk_mask_ref`, return ``(sent, c - sent)``.  Eager
    torch rounds the sum to its storage dtype (the one torch's type
    promotion gives) before selection, as the kernel's ``_force_rounding``
    pins it in the JAX package."""
    corrected = x + residual
    sent = blockwise_topk_mask_ref(corrected, k_per_block, block)
    return sent, corrected - sent


def count_kept(x: torch.Tensor) -> int:
    return int((x != 0).sum())


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_mask_ref(keep: torch.Tensor) -> torch.Tensor:
    """(nb, B) bool -> (nb, B//32) int32 words, LSB-first per word (the bits
    of the wire's uint32 words)."""
    nb, B = keep.shape
    w = keep.reshape(nb, B // 32, 32).to(torch.int64)
    words = (w << _shifts(keep.device)).sum(dim=2)        # in [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_mask_ref(bitmap: torch.Tensor) -> torch.Tensor:
    """(nb, W) int32 words -> (nb, W*32) bool keep-mask."""
    nb, W = bitmap.shape
    words = bitmap.to(torch.int64) & 0xFFFFFFFF
    bits = (words[:, :, None] >> _shifts(bitmap.device)) & 1
    return bits.to(torch.bool).reshape(nb, W * 32)


def encode_topk_ref(x: torch.Tensor, k_per_block: int,
                    block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wire encode: (values (nb, k) in index order, bitmap (nb, B/32) int32
    words).  Tie-capped — exactly k slots per block, the wire's capacity."""
    check_codec_dtype(x)
    tiles = _tiles(x, block)
    nb = tiles.shape[0]
    k = int(min(max(k_per_block, 1), block))
    keep = _keep_capped(_mag_bits(tiles), k)
    # boolean indexing walks rows in order, so each row's k survivors come
    # out in index order
    values = tiles[keep].reshape(nb, k)
    return values, pack_mask_ref(keep)


def decode_topk_ref(values: torch.Tensor, bitmap: torch.Tensor,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`encode_topk_ref`: dense tensor of ``shape``."""
    keep = unpack_mask_ref(bitmap)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    idx = pos.clamp(0, values.shape[1] - 1).to(torch.int64)
    dense = torch.where(keep, torch.gather(values, 1, idx),
                        values.new_zeros(()))
    n = 1
    for s in shape:
        n *= int(s)
    return dense.reshape(-1)[:n].reshape(tuple(shape))


def ef_encode_topk_ref(x: torch.Tensor, residual: torch.Tensor,
                       k_per_block: int, block: int = 4096
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback wire encode: compress (x + residual), return
    (values, bitmap, new_residual) with new_residual = unsent corrected.
    ``x + residual`` is rounded to the storage dtype by the eager addition
    itself, before selection (what ``_force_rounding`` pins in the JAX
    package); the kernel rounds the float sum the same way."""
    corrected = x + residual
    values, bitmap = encode_topk_ref(corrected, k_per_block, block)
    sent = decode_topk_ref(values, bitmap, tuple(corrected.shape))
    return values, bitmap, (corrected - sent).to(x.dtype)
