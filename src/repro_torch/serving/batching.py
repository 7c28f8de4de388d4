"""Continuous batching: the admit-on-slot-free request queue.

Static batching pads every request to the batch's longest generation and
wastes slots on finished sequences; continuous batching (the unchecked back
half of the tLLM roadmap, SNIPPETS.md 3) admits a waiting request the moment
a slot frees, and every request carries its own generation length.

:class:`RequestQueue` is the deterministic core: arrival-ordered FIFO with
simulated-clock visibility (``due(now)`` only surfaces requests that have
actually arrived).  The admission *policy* lives in
:meth:`repro_torch.serving.router.SessionRouter.has_capacity` — a request is
admitted when every stage of some chain has a free slot — and the decode
loop in :class:`repro_torch.serving.runtime.ServingRuntime` re-checks admission at
the top of every round, so a session finishing in round *k* frees its slots
for a new admission in round *k+1*, never at an epoch/batch boundary.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from .reqtrace import Request


class RequestQueue:
    """Arrival-ordered FIFO over a simulated clock."""

    def __init__(self, requests: List[Request]):
        self._q: Deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.n_admitted = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def empty(self) -> bool:
        return not self._q

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def due(self, now: float) -> bool:
        """Is the head request's arrival time <= now?"""
        return bool(self._q) and self._q[0].arrival <= now

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the head request (None when drained) — the idle
        runtime fast-forwards the sim clock to this."""
        return self._q[0].arrival if self._q else None

    def pop(self, now: float) -> Request:
        if not self.due(now):
            raise RuntimeError("pop() with no due request — check due(now)")
        self.n_admitted += 1
        return self._q.popleft()
