"""Decentralized swarm serving (Petals-style inference path), in PyTorch.

The serving twin of the training stack, built on the same substrates: the
decoder stage-sharded over the membership view
(:mod:`~repro_torch.serving.stages`), KV/activation wire pricing through the
calibrated cost-model semantics (:mod:`~repro_torch.serving.costs`), replica
placement with memory-feasible KV slots (:mod:`~repro_torch.serving.plan`),
session routing with mid-session re-route + bit-exact KV replay
(:mod:`~repro_torch.serving.router`, :mod:`~repro_torch.serving.session`), a
continuous-batching request queue (:mod:`~repro_torch.serving.batching`) over
simulated Poisson traffic (:mod:`~repro_torch.serving.reqtrace`), all driven by
the lockstep :class:`~repro_torch.serving.runtime.ServingRuntime` with spans,
metrics, and flight-recorder routing decisions.

The stage executors and the runtime compute on ``device``, ``"cuda"``
unless given ``"cpu"``; without a card they raise.  ``docs/serving.md``
is the user guide of the JAX package's twin, whose API this mirrors.
"""
from .batching import RequestQueue
from .costs import ServingCostModel, StageCost
from .plan import ServingPlan, ServingPlanError, plan_serving
from .reqtrace import Request, poisson_trace
from .router import NoChainError, SessionRouter
from .runtime import ServingReport, ServingRuntime
from .scenario import churn_trace_for, derive_midsession_failure
from .session import Session, StageState, summarize
from .stages import (STAGE_FAMILIES, StageExecutor, StageSpec,
                     check_shardable, split_stages, stage_decode,
                     stage_params, stage_prefill)

__all__ = [
    "NoChainError", "Request", "RequestQueue", "STAGE_FAMILIES",
    "ServingCostModel", "ServingPlan", "ServingPlanError", "ServingReport",
    "ServingRuntime", "Session", "SessionRouter", "StageCost",
    "StageExecutor", "StageSpec", "StageState", "check_shardable",
    "churn_trace_for", "derive_midsession_failure", "plan_serving",
    "poisson_trace", "split_stages", "stage_decode", "stage_params",
    "stage_prefill", "summarize",
]
