"""The frozen arithmetic of the benchmark: a training step's FLOPs, the
wire codec's bytes, and the card's published peaks.

FLOPs: a step is three forward passes' worth (the forward, and twice it
for the gradients of activations and of weights), nothing recomputed.  A
forward is 2 FLOPs a multiply-add of every matrix product: each token
through every projection, MLP and head weight, and attention's two
products (scores and the weighted values) over the full square
``S x S`` of every head, the causal half not taken off; an expert layer
counts the experts a token goes through, not all of them.  Embedding
look-ups, norms, softmax and the update count nothing.  A block's count
is its family's (``portbench/families/<family>.py``, ``block_flops``).

Codec bytes: each input byte read once and each output byte written once.
A compressed edge runs one encode and one decode a direction: the encode
reads the dense tensor (4 bytes an entry) and writes k values and the
block's bitmap (4096 / 32 words of 4 bytes) a block; the decode reads those
and writes the dense tensor.

Peaks: one NVIDIA H100 SXM, its data sheet, dense: 67 TFLOP/s in float32
without the tensor cores (TF32 is off), 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from portbench.harness import manifest

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BLOCK = 4096


def step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Three forwards: each block's ``block_flops`` (its family's) and the
    head."""
    fam = manifest.family(cfg)
    p = max(cfg["vocab_pad_to"], 1)
    V = (cfg["vocab"] + p - 1) // p * p
    blocks = sum(fam.block_flops(cfg, i, batch, seq)
                 for i in range(cfg["n_layers"]))
    return 3.0 * (blocks + 2.0 * batch * seq * cfg["d_model"] * V)


def codec_bytes(numel: int, k: int, itemsize: int = 4) -> Tuple[int, int]:
    """(encode bytes, decode bytes) of one launch each on a tensor of
    ``numel`` entries keeping ``k`` a block."""
    nb = -(-numel // BLOCK)
    wire = nb * k * itemsize + nb * (BLOCK // 32) * 4
    return numel * itemsize + wire, wire + numel * itemsize


def step_codec_bytes(edges: Iterable[Tuple[int, int]]) -> int:
    """Bytes of a step's codec launches: two directions an edge."""
    return sum(2 * sum(codec_bytes(n, k)) for n, k in edges)
