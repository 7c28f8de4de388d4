"""Simulated request traces: the workload side of the serving benchmark.

A deterministic stand-in for "heavy traffic from millions of users": Poisson
arrivals (exponential inter-arrival gaps at ``rate`` requests/s — the
heavy-traffic arrival process of queueing theory) with per-request prompt
lengths and generation lengths drawn uniformly from closed ranges.  Seeded
``numpy`` RNG end to end, so a trace is a pure function of its arguments and
the churn/no-churn benchmark legs replay *exactly* the same offered load.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One user request: a prompt and a per-request generation budget."""

    rid: str
    arrival: float                    # simulated seconds
    prompt: Tuple[int, ...]           # token ids
    max_new_tokens: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


def poisson_trace(n_requests: int, rate: float, vocab: int,
                  prompt_len: Tuple[int, int] = (4, 12),
                  gen_len: Tuple[int, int] = (4, 16),
                  seed: int = 0) -> List[Request]:
    """``n_requests`` Poisson arrivals at ``rate`` req/s, sorted by time."""
    if n_requests <= 0:
        return []
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    out: List[Request] = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        glen = int(rng.integers(gen_len[0], gen_len[1] + 1))
        toks = rng.integers(0, vocab, size=plen)
        out.append(Request(rid=f"r{i}", arrival=float(arrivals[i]),
                           prompt=tuple(int(t) for t in toks),
                           max_new_tokens=glen))
    return out
