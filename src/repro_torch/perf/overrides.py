"""Named perf-iteration override sets.

Each entry bundles the knobs one hypothesis changes — parameter-sharding
overrides, activation rules, config fields — under a name, so a step can be
rebuilt with ``get(name)`` and compared against the baseline.  The sets and
their values are the JAX package's (``repro.perf.overrides``), with the
port's ``PartitionSpec``; the measurements behind them were made on the JAX
package's production mesh, not on this port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.distributed.sharding import PartitionSpec as P

_SETS: Dict[str, Dict[str, Any]] = {}


def register(name: str, **kw) -> None:
    _SETS[name] = kw


def get(name: Optional[str]) -> Optional[Dict[str, Any]]:
    if name is None:
        return None
    return _SETS[name]


def names():
    return sorted(_SETS)


# ---------------------------------------------------------------- H-sets ---

# H-seqpar: Megatron sequence parallelism — residual-stream activations
# sharded over 'model' between blocks; row-matmul psums become
# reduce-scatter + all-gather of S-sharded bf16 tensors.
register("seqpar", rules={"act_seq": "model"})

# H-ep: expert-parallel MoE dispatch — (E, C, d) buffers sharded over the
# model axis; the scatter lowers to all-to-all and each shard computes only
# its local experts.
register("ep", rules={"expert_dispatch": "model"})

# H-ep+seqpar combined.
register("ep_seqpar", rules={"expert_dispatch": "model",
                             "act_seq": "model"})

# H-moe-w: stop FSDP-sharding the expert weights' CONTRACTION dims.  The
# baseline's generic rule shards gate/up on d@data and down on f@data; the
# (E,C,·) dispatch buffers have those dims unsharded, so every expert matmul
# psums an (E,C,f)-sized partial over the data axis.  Replicating the
# contraction dim trades that for weight-sized gathers.
register("moe_w", param_overrides={
    r".*moe/(?:gate|up)": P(
        None, None, None, "model"),
    r".*moe/down": P(
        None, None, "model", None),
})

# H-seqpar-dots: sequence parallelism, and the remat recompute traffic
# traded for saved matmul outputs.
register("seqpar_dots", rules={"act_seq": "model"},
         cfg={"remat_policy": "dots"})

# H-moe-ragged: replace the capacity-dispatch einsum path with
# sort + ragged dispatch (exact active-token FLOPs).
register("moe_ragged", cfg={"moe_impl": "ragged"})

# H-moe-w + sequence parallelism on the attention side.
register("moe_w_seqpar", rules={"act_seq": "model"}, param_overrides={
    r".*moe/(?:gate|up)": P(
        None, None, None, "model"),
    r".*moe/down": P(
        None, None, "model", None),
})
