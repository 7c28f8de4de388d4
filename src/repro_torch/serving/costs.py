"""Serving cost model: KV/activation wire pricing + per-stage decode pace.

This is the serving twin of :class:`repro_torch.core.costmodel.EdgeCostModel`, and
it deliberately prices bytes the same way training does:

* **wire bytes** come from the activation dtype's itemsize (dtype-aware, not
  a hard-coded fp32) — a bf16 swarm ships half the boundary bytes of an fp32
  one, exactly as the training cost model's profile-derived ``itemsize``;
* **link seconds** go through ``ClusterSpec.comm_time`` (the α–β primitive)
  scaled by the same telemetry-calibrated ``link_corrections`` the training
  loop fits with :func:`repro_torch.core.costmodel.fit_link_corrections` — a
  correction learned during training reprices serving routes for free
  (:meth:`ServingCostModel.from_cost_model` lifts corrections straight off a
  live ``EdgeCostModel``);
* **compute seconds** are analytic decode FLOPs over ``DeviceSpec.speed``
  (S(p) = λ_p·S*(p)), the paper's Eq. 1 ``C(f,p)`` term.

Byte quantities priced here, per session:

* ``act_bytes_per_token`` — one boundary hidden vector ``(1, 1, d_model)``,
  the per-hop payload of stage-chained decode;
* ``kv_bytes_per_token(spec)`` — the K+V rows one token appends across a
  stage's layers: what a mid-session re-route would have to *move* if we
  shipped the cache instead of replaying it (the router charges the cheaper
  replay; the planner uses this for per-stage KV placement feasibility);
* ``stage_param_bytes(spec)`` — the resident weights a replica hosts, for
  the memory-feasibility gate in :func:`repro_torch.serving.plan.plan_serving`.

This module is where raw itemsize arithmetic lives — everything downstream
prices through it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.costmodel import EdgeCostModel
from repro_torch.core.estimator import ClusterSpec

from .stages import StageSpec

TOKEN_ID_BYTES = 4   # int32 token ids on the client->stage0 hop


def _itemsize(dtype) -> int:
    """Bytes per element of a torch dtype, or of one named by a string
    (``"bfloat16"``), as ``jnp.dtype(...).itemsize`` accepts both."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return int(dtype.itemsize)


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Resolved per-stage serving costs (one replica's view)."""

    spec: StageSpec
    param_bytes: int
    kv_bytes_per_token: int
    decode_flops: float          # one token through the stage (cache_len att)
    in_bytes_per_token: int      # payload arriving at this stage per token


class ServingCostModel:
    """Prices the serving swarm on a cluster: bytes per hop, seconds per
    stage, KV placement feasibility.  Immutable by convention, like
    ``EdgeCostModel``."""

    def __init__(self, cfg: ModelCfg, cluster: ClusterSpec,
                 link_corrections: Optional[Mapping[Tuple[int, int],
                                                   float]] = None):
        self.cfg = cfg
        self.cluster = cluster
        self.link_corrections: Dict[Tuple[int, int], float] = \
            dict(link_corrections or {})
        self._act_itemsize = _itemsize(cfg.dtype)
        self._param_itemsize = _itemsize(cfg.param_dtype)

    @staticmethod
    def from_cost_model(cfg: ModelCfg, model: EdgeCostModel
                        ) -> "ServingCostModel":
        """Adopt a training loop's calibrated belief: same α–β cluster, same
        fitted link corrections — serving routes are priced on what the
        training telemetry actually measured."""
        return ServingCostModel(cfg, model.cluster, model.link_corrections)

    def with_link_corrections(self, corrections: Mapping[Tuple[int, int],
                                                         float]
                              ) -> "ServingCostModel":
        return ServingCostModel(self.cfg, self.cluster, corrections)

    # ------------------------------------------------------------- bytes --
    @property
    def act_itemsize(self) -> int:
        return self._act_itemsize

    def act_bytes_per_token(self) -> int:
        """One boundary hidden state (1, 1, d_model) at the activation
        dtype — the per-token stage-to-stage payload."""
        return self.cfg.d_model * self._act_itemsize

    def stage_in_bytes_per_token(self, spec: StageSpec) -> int:
        """Per-token payload arriving at a stage: raw token ids into the
        first stage (the client hop), boundary hiddens everywhere else."""
        return TOKEN_ID_BYTES if spec.first else self.act_bytes_per_token()

    def kv_bytes_per_token(self, spec: StageSpec) -> int:
        """K+V rows one token appends across the stage's layers."""
        cfg = self.cfg
        per_layer = 2 * cfg.n_kv_heads * cfg.head_dim * self._act_itemsize
        return spec.n_layers * per_layer

    def kv_bytes(self, spec: StageSpec, cache_len: int) -> int:
        """Resident KV cache of one session slot at full ``cache_len``."""
        return self.kv_bytes_per_token(spec) * int(cache_len)

    def stage_param_bytes(self, spec: StageSpec) -> int:
        """Analytic resident weight bytes of one replica (mirrors
        ``causal_lm.count_params`` for the dense/moe block, plus the
        embed/head tables on the boundary stages)."""
        cfg = self.cfg
        d, V = cfg.d_model, cfg.vocab_padded
        nrm = 2 * d if cfg.norm == "layernorm" else d
        attn_p = (d * cfg.n_heads * cfg.head_dim * 2
                  + d * cfg.n_kv_heads * cfg.head_dim * 2
                  + (cfg.n_heads * cfg.head_dim
                     + 2 * cfg.n_kv_heads * cfg.head_dim
                     if cfg.qkv_bias else 0))
        mults = 3 if cfg.act in ("silu", "swiglu") else 2
        if cfg.family == "moe":
            ffn_p = (d * cfg.n_experts
                     + cfg.n_experts * d * cfg.d_ff * 3
                     + (d * cfg.n_shared_experts * cfg.d_ff * 3
                        if cfg.n_shared_experts else 0))
        else:
            ffn_p = d * cfg.d_ff * mults
        per_layer = attn_p + ffn_p + 2 * nrm
        total = spec.n_layers * per_layer
        if spec.first or (spec.last and cfg.tie_embeddings):
            total += V * d
        if spec.first and cfg.rope_fraction == 0.0:
            total += cfg.max_seq * d
        if spec.last:
            total += nrm
            if not cfg.tie_embeddings:
                total += d * V
        return total * self._param_itemsize

    # ----------------------------------------------------------- seconds --
    def stage_decode_flops(self, spec: StageSpec, cache_len: int) -> float:
        """One token through the stage, attending over ``cache_len`` keys
        (the conservative full-cache bound; decode FLOPs grow with position
        but the planner prices the steady state)."""
        cfg = self.cfg
        d = cfg.d_model
        qk = cfg.n_heads * cfg.head_dim
        kv = cfg.n_kv_heads * cfg.head_dim
        attn = (2 * d * (qk + 2 * kv)            # qkv projections
                + 2 * qk * d                     # output projection
                + 4 * cfg.n_heads * cfg.head_dim * cache_len)  # scores+mix
        mults = 3 if cfg.act in ("silu", "swiglu") else 2
        if cfg.family == "moe":
            active = cfg.top_k + cfg.n_shared_experts
            ffn = 2 * d * cfg.n_experts + active * 3 * 2 * d * cfg.d_ff
        else:
            ffn = mults * 2 * d * cfg.d_ff
        total = spec.n_layers * (attn + ffn)
        if spec.last:
            total += 2 * d * cfg.vocab_padded    # LM head
        return float(total)

    def stage_seconds(self, device: int, spec: StageSpec,
                      cache_len: int) -> float:
        """Eq. 1 C(f,p): one token's compute on a replica of ``spec``."""
        return self.cluster.compute_time(
            self.stage_decode_flops(spec, cache_len), device)

    def link_seconds(self, src: int, dst: int, nbytes: float) -> float:
        """α–β seconds on the directed (src, dst) link, scaled by the
        calibrated correction — identical semantics to
        ``EdgeCostModel.link_seconds``."""
        if src == dst:
            return 0.0
        t = self.cluster.comm_time(src, dst, nbytes)
        return t * self.link_corrections.get((src, dst), 1.0)

    def hop_seconds(self, src: int, dst: int, spec: StageSpec) -> float:
        """One token's boundary payload into a replica of ``spec``."""
        return self.link_seconds(src, dst, self.stage_in_bytes_per_token(spec))

    def stage_costs(self, spec: StageSpec, cache_len: int) -> StageCost:
        return StageCost(
            spec=spec,
            param_bytes=self.stage_param_bytes(spec),
            kv_bytes_per_token=self.kv_bytes_per_token(spec),
            decode_flops=self.stage_decode_flops(spec, cache_len),
            in_bytes_per_token=self.stage_in_bytes_per_token(spec))
