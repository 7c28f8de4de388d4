"""Step builders of the gspmd path, on one device.

The JAX package jits these steps with explicit shardings over the mesh; on
one card the train step is plain autograd (``train_loss`` -> gradients ->
``clip_by_global_norm`` -> ``optimizer.update``), and the prefill and
decode steps call ``causal_lm.prefill`` / ``decode_step`` eagerly, for
every family ``causal_lm`` has (the hybrid included: it is served this way,
never stage-sharded).  The input specs and shardings come with ROADMAP
Q1.4, the encdec family with Q1.3c.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.opgraph import tree_leaves
from repro_torch.core.rad import tree_map
from repro_torch.models import causal_lm
from repro_torch.optim import Optimizer, clip_by_global_norm


def _check_family(cfg: ModelCfg) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encdec family is not ported yet (ROADMAP Q1.3c)")


def loss_and_grad(cfg: ModelCfg, params, batch):
    """(loss, metrics, grads) of ``causal_lm.train_loss`` at ``params``;
    grads has params' key paths."""
    _check_family(cfg)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = causal_lm.train_loss(cfg, leaves, batch)
    flat = tree_leaves(leaves)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: grads[id(p)], leaves))


def make_train_step(cfg: ModelCfg, optimizer: Optimizer,
                    grad_clip: float = 1.0) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "ce", "aux"})``."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grad(cfg, params, batch)
        if grad_clip:
            # rebinding drops the unclipped tree before the update
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
        params, opt_state = optimizer.update(grads, opt_state, params)
        out_metrics = {"loss": loss, "grad_norm": gnorm}
        out_metrics.update(metrics)
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelCfg, cache_len: int,
                      window: Optional[int] = None) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits, cache)``."""
    _check_family(cfg)

    def prefill_step(params, batch):
        return causal_lm.prefill(cfg, params, batch["tokens"],
                                 cache_len=cache_len,
                                 prefix_embeds=batch.get("prefix_embeds"),
                                 window=window)
    return prefill_step


def make_decode_step(cfg: ModelCfg, window: Optional[int] = None) -> Callable:
    """``serve_step(params, cache, tokens) -> (logits, new cache)``: one new
    token against the cache, which is left as it was."""
    _check_family(cfg)

    def serve_step(params, cache, tokens):
        return causal_lm.decode_step(cfg, params, cache, tokens,
                                     window=window)
    return serve_step
