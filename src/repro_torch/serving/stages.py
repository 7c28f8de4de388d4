"""Stage-sharded decoder: the model side of the serving swarm.

Training pipelines this repo shards at the *op* granularity (OP-Fence over
the metadata OP-DAG).  Serving wants something coarser and
replica-friendly: the Petals deployment unit is a contiguous *run of
transformer blocks* a volunteer can host, with embeddings on the first hop
and the LM head on the last (SNIPPETS.md 1–2: ``RemoteSequential`` holds
the block run, the client owns sampling).  This module slices the
:mod:`repro_torch.models.causal_lm` decoder the same way:

* :class:`StageSpec` — one contiguous ``[lo, hi)`` layer slice of the
  stacked block params, plus whether this stage embeds tokens (first) and
  applies the final norm + head (last);
* :func:`split_stages` — near-equal contiguous split of ``cfg.n_layers``;
* :func:`stage_params` — the parameter subtree one stage replica hosts
  (block slice — views of the stacked leaves — + embed table on the first
  stage, head on the last; a tied head means the last stage also carries
  the embed table);
* :func:`stage_prefill` / :func:`stage_decode` — the per-stage forward
  paths.  They run the *same* embedding, per-segment loops and head as
  the monolithic ``prefill`` / ``decode_step`` (``causal_lm.blocks_prefill``
  / ``blocks_decode``), so a chain of stages is **bit-identical** to the
  single-process model (pinned in ``tests/test_torch_serving.py`` and on
  the card by ``chip_smoke.py``) — which is what makes mid-session
  re-routing testable: replaying a session's inputs through a replacement
  replica must reproduce its KV cache exactly.

Families supported: ``dense`` and ``moe`` — the KV-cache families whose
block stack is a single segment.  Recurrent-state families (hybrid/xLSTM)
and prefix-fed VLMs keep the monolithic path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.rad import tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.causal_lm import (_embed_step, _embed_tokens, _head,
                                          blocks_decode, blocks_prefill,
                                          segments)
from repro_torch.models.layers import norm_apply

STAGE_FAMILIES = ("dense", "moe")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One contiguous slice ``[lo, hi)`` of the stacked block params."""

    index: int
    n_stages: int
    lo: int
    hi: int

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.n_stages - 1

    @property
    def n_layers(self) -> int:
        return self.hi - self.lo

    def __str__(self) -> str:
        return f"stage{self.index}[{self.lo}:{self.hi}]"


def check_shardable(cfg: ModelCfg) -> None:
    """Raise unless ``cfg`` is a single-segment KV-cache decoder."""
    if cfg.family not in STAGE_FAMILIES:
        raise ValueError(
            f"{cfg.name}: stage-sharded serving supports {STAGE_FAMILIES}, "
            f"not family {cfg.family!r} (recurrent-state caches cannot be "
            "sliced per layer range yet)")
    if cfg.n_prefix > 0:
        raise ValueError(f"{cfg.name}: prefix-fed models (n_prefix="
                         f"{cfg.n_prefix}) keep the monolithic path")
    segs = segments(cfg)
    if len(segs) != 1 or segs[0].name != "blocks":
        raise ValueError(f"{cfg.name}: expected one stacked 'blocks' "
                         f"segment, got {[s.name for s in segs]}")


def split_stages(cfg: ModelCfg, n_stages: int) -> List[StageSpec]:
    """Near-equal contiguous layer split (earlier stages take the
    remainder, matching the pipeline convention)."""
    check_shardable(cfg)
    if not (1 <= n_stages <= cfg.n_layers):
        raise ValueError(f"n_stages must be in [1, {cfg.n_layers}], "
                         f"got {n_stages}")
    base, rem = divmod(cfg.n_layers, n_stages)
    out: List[StageSpec] = []
    lo = 0
    for i in range(n_stages):
        hi = lo + base + (1 if i < rem else 0)
        out.append(StageSpec(index=i, n_stages=n_stages, lo=lo, hi=hi))
        lo = hi
    return out


def stage_params(cfg: ModelCfg, params: Dict[str, Any],
                 spec: StageSpec) -> Dict[str, Any]:
    """The parameter subtree one replica of ``spec`` hosts; the block
    slice is a view of the stacked leaves (no copy)."""
    sp: Dict[str, Any] = {"blocks": tree_map(lambda a: a[spec.lo:spec.hi],
                                             params["blocks"])}
    if spec.first or (spec.last and cfg.tie_embeddings):
        sp["embed"] = params["embed"]
    if spec.first and cfg.rope_fraction == 0.0:
        sp["pos_embed"] = params["pos_embed"]
    if spec.last:
        sp["final_norm"] = params["final_norm"]
        if not cfg.tie_embeddings:
            sp["head"] = params["head"]
    return sp


def _kind(cfg: ModelCfg) -> str:
    return "dense" if cfg.family == "dense" else "moe"


@torch.inference_mode()
def stage_prefill(cfg: ModelCfg, spec: StageSpec, sp: Dict[str, Any],
                  inp: torch.Tensor, cache_len: int,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt forward through one stage.

    ``inp`` is ``(B, S)`` int tokens on the first stage, ``(B, S, d)``
    hidden states otherwise.  Returns ``(out, kv)`` where ``out`` is the
    boundary hidden states ``(B, S, d)`` (last-position logits ``(B, 1, V)``
    on the last stage) and ``kv`` the stage's stacked
    ``{"k", "v"}: (n_layers, B, cache_len, H_kv, hd)`` cache.
    """
    window = window if window is not None else cfg.window
    x = _embed_tokens(cfg, sp, inp, None) if spec.first else inp
    x, kv = blocks_prefill(cfg, _kind(cfg), sp["blocks"], x, window,
                           cache_len)
    if spec.last:
        h = norm_apply(cfg.norm, sp["final_norm"], x[:, -1:, :])
        return _head(cfg, sp, h), kv
    return x, kv


@torch.inference_mode()
def stage_decode(cfg: ModelCfg, spec: StageSpec, sp: Dict[str, Any],
                 inp: torch.Tensor, kv: Dict[str, torch.Tensor],
                 pos: torch.Tensor, window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode through one stage.

    ``inp`` is ``(B, 1)`` int tokens on the first stage, ``(B, 1, d)``
    hidden states otherwise; ``pos`` the 0-d int32 index of this token.
    Returns ``(out, kv)`` with ``out`` the boundary hidden ``(B, 1, d)``
    (logits ``(B, 1, V)`` on the last stage) and ``kv`` a new cache (the
    one given is left as it was).
    """
    window = window if window is not None else cfg.window
    x = _embed_step(cfg, sp, inp, pos) if spec.first else inp
    x, new_kv = blocks_decode(cfg, _kind(cfg), sp["blocks"], x, kv, pos,
                              window)
    if spec.last:
        h = norm_apply(cfg.norm, sp["final_norm"], x)
        return _head(cfg, sp, h), new_kv
    return x, new_kv


class StageExecutor:
    """Prefill/decode for one :class:`StageSpec`, eagerly on ``device``.

    One executor is shared by every replica of a stage (replicas host
    byte-identical parameters).  The parameters are moved to ``device``
    once (a no-op for tensors already there, so the block slice stays a
    view of the stack).  ``device`` defaults to ``"cuda"`` and raises
    without a card.
    """

    def __init__(self, cfg: ModelCfg, spec: StageSpec,
                 sp: Dict[str, Any], cache_len: int,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), sp)
        self.cache_len = int(cache_len)

    def prefill(self, inp: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return stage_prefill(self.cfg, self.spec, self.params, inp,
                             self.cache_len)

    def decode(self, inp: torch.Tensor, kv: Dict[str, torch.Tensor],
               pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if not 0 <= pos < self.cache_len:
            raise ValueError(f"{self.spec}: decode position {pos} is "
                             f"outside the cache (cache_len "
                             f"{self.cache_len})")
        return stage_decode(self.cfg, self.spec, self.params, inp, kv,
                            torch.tensor(pos, dtype=torch.int32,
                                         device=self.device))
