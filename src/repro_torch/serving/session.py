"""Inference sessions: per-request state, including what re-routing needs.

A :class:`Session` is the server-side mirror of Petals'
``InferenceSession`` (SNIPPETS.md 2): the KV caches it has accumulated on
each stage of its chain, plus the **input history** each stage consumed —
the prompt (token ids into stage 0, boundary hiddens into later stages) and
every per-token decode input since.

The history is what makes mid-session re-routing *exact*: when a replica
dies, the replacement rebuilds the session's KV prefix by replaying the
recorded inputs through the **same stage functions** that produced the
original cache — same op order, same reduction order, bit-identical KV
(pinned in ``tests/test_torch_serving.py``: churn and no-churn runs emit
identical tokens under greedy decode).  Shipping the surviving KV tensors instead
would cost ``kv_bytes_per_token × pos`` on the wire; the router charges
whichever the cost model says is cheaper (see
:meth:`repro_torch.serving.router.SessionRouter.reroute`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .reqtrace import Request


@dataclasses.dataclass
class StageState:
    """One stage's view of a session: its KV plus the inputs that built it."""

    kv: Optional[Dict[str, torch.Tensor]] = None
    prefill_input: Optional[torch.Tensor] = None   # tokens (1,S) or hiddens
    step_inputs: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def record_prefill(self, inp: torch.Tensor, kv: Dict[str, torch.Tensor]) -> None:
        self.prefill_input = inp
        self.kv = kv

    def record_step(self, inp: torch.Tensor, kv: Dict[str, torch.Tensor]) -> None:
        self.step_inputs.append(inp)
        self.kv = kv


@dataclasses.dataclass
class Session:
    """One admitted request's live state across its chain of replicas."""

    request: Request
    chain: List[int]                     # device id per stage
    admitted_at: float
    stages: List[StageState] = dataclasses.field(default_factory=list)
    pos: int = 0                         # tokens consumed (prompt + decoded)
    generated: List[int] = dataclasses.field(default_factory=list)
    token_latencies: List[float] = dataclasses.field(default_factory=list)
    n_reroutes: int = 0
    finished_at: Optional[float] = None

    def __post_init__(self):
        if not self.stages:
            self.stages = [StageState() for _ in self.chain]

    @property
    def rid(self) -> str:
        return self.request.rid

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.request.max_new_tokens

    @property
    def next_pos(self) -> int:
        """Cache position the next decode token writes at."""
        return self.pos

    def replay_len(self, stage: int) -> int:
        """Tokens the replacement replica must re-consume to rebuild this
        stage's KV: the prefill prompt plus every decode step so far."""
        st = self.stages[stage]
        plen = 0 if st.prefill_input is None \
            else int(st.prefill_input.shape[1])
        return plen + len(st.step_inputs)


def summarize(sessions: List[Session]) -> Dict[str, Any]:
    """Completion stats over a run's sessions (benchmark reporting)."""
    done = [s for s in sessions if s.done]
    return {
        "n_sessions": len(sessions),
        "n_completed": len(done),
        "all_completed": len(done) == len(sessions),
        "n_reroutes": sum(s.n_reroutes for s in sessions),
        "tokens": sum(len(s.generated) for s in sessions),
    }
