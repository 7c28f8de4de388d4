"""Step builders and abstract input specs of the gspmd path, on one device.

The JAX package jits these steps with explicit shardings over the mesh; on
one card the train step is plain autograd (``train_loss`` -> gradients ->
``clip_by_global_norm`` -> ``optimizer.update``), and the prefill and
decode steps call the model's ``prefill`` / ``decode_step`` eagerly:
``encdec``'s for the encoder-decoder, ``causal_lm``'s for every other
family (the hybrid and xLSTM included: they are served this way, never
stage-sharded).

The abstract inputs (:func:`input_specs`, :func:`decode_state_specs`) are
tensors on the ``meta`` device, in the JAX package's trees.  The shardings
and ``build_jitted`` come with ROADMAP Q1.4.

Step kinds per input shape:
* train_4k    -> ``train_step(params, opt_state, batch)``
* prefill_32k -> ``prefill_step(params, batch)``
* decode_32k / long_500k -> ``serve_step(params, cache, tokens)`` — one new
  token against a seq_len-deep cache.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelCfg
from repro_torch.core.opgraph import tree_leaves
from repro_torch.core.rad import tree_map
from repro_torch.models import causal_lm, encdec
from repro_torch.optim import Optimizer, clip_by_global_norm


# ============================================================ input specs ==
def src_len_for(cfg: ModelCfg, seq_len: int) -> int:
    """Audio source frames for enc-dec shapes (8 tokens/frame heuristic)."""
    return max(seq_len // 8, 16)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Abstract batch (``meta`` tensors) for train/prefill shapes (decode
    builds caches too — see :func:`decode_state_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        spec = {"src_embeds": _spec((B, src_len_for(cfg, S),
                                     cfg.d_frontend), cfg.dtype),
                "tokens": _spec((B, S), i32)}
        if shape.kind == "train":
            spec["labels"] = _spec((B, S), i32)
        return spec
    S_text = S - cfg.n_prefix if cfg.n_prefix else S
    spec = {"tokens": _spec((B, S_text), i32)}
    if shape.kind == "train":
        spec["labels"] = _spec((B, S_text), i32)
    if cfg.n_prefix:
        spec["prefix_embeds"] = _spec((B, cfg.n_prefix, cfg.d_frontend),
                                      cfg.dtype)
    return spec


def decode_window(cfg: ModelCfg, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k":
        return cfg.long_window or cfg.window
    return cfg.window


def decode_state_specs(cfg: ModelCfg, shape: InputShape) -> Any:
    """Abstract decode cache (``meta`` tensors) for the serve step."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return encdec.cache_init(cfg, B, S, src_len_for(cfg, S),
                                 device="meta")
    return causal_lm.cache_init(cfg, B, S, device="meta")


# ================================================================== steps ==
def loss_and_grad(cfg: ModelCfg, params, batch):
    """(loss, metrics, grads) of the model's ``train_loss`` at ``params``;
    grads has params' key paths."""
    model = encdec if cfg.family == "encdec" else causal_lm
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = model.train_loss(cfg, leaves, batch)
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
    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return encdec.prefill(cfg, params, batch["src_embeds"],
                                  batch["tokens"], cache_len)
    else:
        def prefill_step(params, batch):
            return causal_lm.prefill(cfg, params, batch["tokens"],
                                     cache_len=cache_len,
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     window=window)
    return prefill_step


def make_decode_step(cfg: ModelCfg, window: Optional[int] = None) -> Callable:
    """``serve_step(params, cache, tokens) -> (logits, new cache)``: one new
    token against the cache, which is left as it was."""
    if cfg.family == "encdec":
        def serve_step(params, cache, tokens):
            return encdec.decode_step(cfg, params, cache, tokens)
    else:
        def serve_step(params, cache, tokens):
            return causal_lm.decode_step(cfg, params, cache, tokens,
                                         window=window)
    return serve_step
