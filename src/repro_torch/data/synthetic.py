"""Synthetic-but-learnable datasets.

The paper trains on CIFAR-10 / TinyImageNet / WikiText-2; offline we need
datasets with real structure so convergence comparisons (dense vs uniform
TopK vs AdaTopK, paper Fig. 8) are meaningful, not noise:

* :class:`SyntheticLM` — order-2 Markov language: next token is a fixed
  random function of the two previous tokens plus noise.  A model must learn
  the transition table; loss floors well below log(vocab).
* :class:`SyntheticImages` — class templates + Gaussian noise; labels are
  recoverable by any conv/MLP classifier.
* :class:`SyntheticSeq2Seq` — "translation": target = source tokens mapped
  through a fixed permutation, reversed; source embeddings synthesized from
  the source tokens (stands in for the stubbed audio frontend).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    seed: int = 0
    noise: float = 0.1      # fraction of random tokens
    order: int = 2          # Markov order (1 = easier, learns in ~100 steps)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        if self.order == 1:
            self.table = rng.integers(0, self.vocab, size=(self.vocab,))
        else:
            self.table = rng.integers(0, self.vocab,
                                      size=(self.vocab, self.vocab))

    def batch(self, batch_size: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + 7919 * step + 1)
        toks = np.empty((batch_size, self.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch_size)
        toks[:, 1] = rng.integers(0, self.vocab, size=batch_size)
        for t in range(2, self.seq_len + 1):
            if self.order == 1:
                nxt = self.table[toks[:, t - 1]]
            else:
                nxt = self.table[toks[:, t - 2], toks[:, t - 1]]
            noise_mask = rng.random(batch_size) < self.noise
            nxt = np.where(noise_mask,
                           rng.integers(0, self.vocab, size=batch_size), nxt)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class SyntheticImages:
    n_classes: int = 10
    hw: int = 32
    channels: int = 3
    seed: int = 0
    noise: float = 0.5

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.normal(
            size=(self.n_classes, self.hw, self.hw, self.channels)).astype(
                np.float32)

    def batch(self, batch_size: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + 104729 * step + 1)
        y = rng.integers(0, self.n_classes, size=batch_size)
        x = self.templates[y] + self.noise * rng.normal(
            size=(batch_size, self.hw, self.hw, self.channels)).astype(
                np.float32)
        return {"images": x.astype(np.float32), "labels": y.astype(np.int32)}


@dataclasses.dataclass
class SyntheticSeq2Seq:
    vocab: int
    src_len: int
    tgt_len: int
    d_frontend: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.perm = rng.permutation(self.vocab)
        self.frontend = rng.normal(
            size=(self.vocab, self.d_frontend)).astype(np.float32) * 0.5

    def batch(self, batch_size: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + 611953 * step + 1)
        src = rng.integers(0, self.vocab, size=(batch_size, self.src_len))
        # target: permuted source, repeated/truncated to tgt_len, shifted
        mapped = self.perm[src][:, ::-1]
        reps = -(-(self.tgt_len + 1) // self.src_len)
        tgt = np.tile(mapped, (1, reps))[:, :self.tgt_len + 1]
        return {"src_embeds": self.frontend[src],
                "tokens": tgt[:, :-1].astype(np.int32),
                "labels": tgt[:, 1:].astype(np.int32)}


def make_batch_iterator(ds, batch_size: int, start_step: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield ds.batch(batch_size, step)
        step += 1
