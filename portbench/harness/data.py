"""The token stream: a copy of the repository's synthetic Markov language
(``SyntheticLM``), drawn for all rows of a run at once from the seed.

Each row starts with two uniform tokens; every next token is a fixed
random function (the transition table, drawn first) of the token before
(order 1) or of the two before (order 2), replaced by a uniform token with
probability ``noise``.  Labels are the tokens shifted by one.
"""
from __future__ import annotations

import numpy as np


def markov_batches(vocab: int, batch: int, seq: int, n_batches: int,
                   seed: int, order: int = 1, noise: float = 0.1):
    """(tokens, labels): int64 arrays of shape (n_batches, batch, seq)."""
    if order not in (1, 2):
        raise ValueError(f"Markov order must be 1 or 2, got {order}")
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vocab, size=(vocab,) * order)
    rows = n_batches * batch
    toks = np.empty((rows, seq + 1), dtype=np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=rows)
    toks[:, 1] = rng.integers(0, vocab, size=rows)
    for t in range(2, seq + 1):
        nxt = (table[toks[:, t - 1]] if order == 1
               else table[toks[:, t - 2], toks[:, t - 1]])
        swap = rng.random(rows) < noise
        toks[:, t] = np.where(swap, rng.integers(0, vocab, size=rows), nxt)
    toks = toks.reshape(n_batches, batch, seq + 1)
    return toks[..., :-1].copy(), toks[..., 1:].copy()
