"""Decoder-only causal LM: the dense and vlm families.

* ``dense`` — (GQA + SwiGLU/GELU) × L (llama3, mistral-nemo, stablelm,
  granite, gpt2);
* ``vlm``   — the dense LM consuming stub patch embeddings (internvl2).

The blocks' parameters are stacked on a leading axis of ``n_layers``, as
in the JAX package, so the two packages' trees have the same key paths and
shapes; :func:`repro_torch.models.scan_config.scan` runs them in a loop.
The MoE family comes with ROADMAP Q1.2, the hybrid and xLSTM families with
Q1.3, and so do ``cache_init``, ``prefill`` and ``decode_step``.

Entry points:
  ``init``          params (blocks stacked per segment)
  ``forward``       full-sequence logits and the auxiliary loss
  ``train_loss``    teacher-forced loss (the gspmd training step's)
  ``count_params``  analytic parameter count
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.opgraph import split_generator
from repro_torch.core.rad import tree_map
from . import attention as attn
from .layers import (cross_entropy, dense, dense_init, embed, embed_init,
                     mlp, mlp_init, norm_apply, norm_init)
from .scan_config import scan

_NOT_PORTED = {"moe": "ROADMAP Q1.2", "hybrid": "ROADMAP Q1.3",
               "xlstm": "ROADMAP Q1.3"}


class Segment(NamedTuple):
    name: str       # params key
    kind: str       # dense (the only kind ported)
    count: int      # scan trip count
    inner: int = 0  # inner layers per trip (grouped kinds)


def segments(cfg: ModelCfg) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("blocks", "dense", cfg.n_layers)]
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({_NOT_PORTED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")


# ==================================================================== init ==
def _dense_block_init(gen, cfg: ModelCfg):
    g1, g2 = split_generator(gen, 2)
    dev = gen.device
    return {"ln1": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
            "attn": attn.attn_init(g1, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.param_dtype, cfg.qkv_bias),
            "ln2": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
            "mlp": mlp_init(g2, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.param_dtype)}


def _stack_init(init_fn, gen: torch.Generator, n: int):
    """``n`` blocks, each from its own generator split from ``gen``, stacked
    on a new leading axis.  Each block is copied into a preallocated stack
    as soon as it is drawn, so one block is held beside the stack, not n."""
    stacked = None
    for i, g in enumerate(split_generator(gen, n)):
        blk = init_fn(g)
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                               blk)
        tree_map(lambda s, t: s[i].copy_(t), stacked, blk)
    return stacked


def init(cfg: ModelCfg, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``gen``'s device, with the JAX package's key
    paths and shapes (the values differ: torch cannot draw ``jax.random``'s
    numbers; carry JAX's weights with ``from_numpy_tree`` to compare)."""
    ks = split_generator(gen, 8)
    dev = gen.device
    params: Dict[str, Any] = {
        "embed": embed_init(ks[0], cfg.vocab_padded, cfg.d_model,
                            cfg.param_dtype),
        "final_norm": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(ks[1], cfg.d_model, cfg.vocab_padded,
                                    cfg.param_dtype, scale=0.02)
    if cfg.rope_fraction == 0.0:
        params["pos_embed"] = embed_init(ks[2], cfg.max_seq, cfg.d_model,
                                         cfg.param_dtype)
    if cfg.n_prefix > 0:
        params["prefix_proj"] = dense_init(ks[3], cfg.d_frontend, cfg.d_model,
                                           cfg.param_dtype)
    segs = segments(cfg)
    for seg, g in zip(segs, split_generator(ks[4], len(segs))):
        params[seg.name] = _stack_init(
            lambda r: _dense_block_init(r, cfg), g, seg.count)
    return params


# ============================================================ block apply ==
def _attn_kwargs(cfg: ModelCfg, window: Optional[int]):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, window=window,
                rope_fraction=cfg.rope_fraction, rope_theta=cfg.rope_theta)


def _dense_block(cfg, p, x, window):
    h = norm_apply(cfg.norm, p["ln1"], x)
    x = x + attn.attn_train(p["attn"], h, causal=True,
                            **_attn_kwargs(cfg, window))
    h = norm_apply(cfg.norm, p["ln2"], x)
    return x + mlp(p["mlp"], h, cfg.act)


# ================================================================== remat ==
def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of plain matmuls (``mm``/``addmm``) and recompute the rest,
    batched attention products (``bmm``) included — JAX's
    ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(cfg: ModelCfg, fn):
    """``fn`` checkpointed per call as ``cfg.remat``/``remat_policy`` ask
    (the JAX package's ``jax.checkpoint`` around each scanned block)."""
    if not cfg.remat:
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


# =============================================================== forward ==
def _pick(tree, idx):
    """Layer ``idx`` of a stacked tree.  Not for a loop over layers: each
    ``a[idx]`` costs a backward the size of the whole stack (``scan``
    unbinds instead)."""
    return tree_map(lambda a: a[idx], tree)


def _embed_tokens(cfg: ModelCfg, params, tokens, prefix_embeds, pos0=0):
    x = embed(params["embed"], tokens, cfg.dtype)
    if cfg.rope_fraction == 0.0:
        S = tokens.shape[1]
        pos = torch.arange(pos0, pos0 + S, device=tokens.device)
        x = x + embed(params["pos_embed"], pos, cfg.dtype)[None]
    if cfg.n_prefix > 0:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} requires prefix_embeds")
        pref = dense(params["prefix_proj"], prefix_embeds.to(cfg.dtype))
        x = torch.cat([pref, x], dim=1)
    return x


def forward(cfg: ModelCfg, params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss).  The JAX
    package's sharding ``constrain`` calls are the identity on one device
    and are left out."""
    window = window if window is not None else cfg.window
    x = _embed_tokens(cfg, params, tokens, prefix_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _checkpointed(
        cfg, lambda h, pl: _dense_block(cfg, pl, h, window))
    for seg in segments(cfg):
        x, _ = scan(lambda h, pl: (block(h, pl), None), x, params[seg.name])
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), aux


def _head(cfg, params, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = dense(params["head"], x)
    if cfg.vocab_padded != cfg.vocab:
        # mask padding classes so the softmax is over the true vocabulary
        valid = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(valid, logits, logits.new_full((), -1e30))
    return logits


def train_loss(cfg: ModelCfg, params, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"))
    if cfg.n_prefix > 0:
        logits = logits[:, cfg.n_prefix:, :]
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + cfg.aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ============================================================== analytics ==
def count_params(cfg: ModelCfg) -> int:
    """Analytic parameter count (held against ``init`` and against the JAX
    package in the tests).  The MoE arithmetic is here although its block
    is not; the hybrid and xLSTM counts need their block configs
    (ROADMAP Q1.3) and raise."""
    d, V = cfg.d_model, cfg.vocab_padded
    total = V * d                                 # embed
    if not cfg.tie_embeddings:
        total += d * V                            # head
    if cfg.rope_fraction == 0.0:
        total += cfg.max_seq * d
    if cfg.n_prefix > 0:
        total += cfg.d_frontend * d
    nrm = 2 * d if cfg.norm == "layernorm" else d
    total += nrm                                  # final norm

    attn_params = (d * cfg.n_heads * cfg.head_dim * 2
                   + d * cfg.n_kv_heads * cfg.head_dim * 2
                   + (cfg.n_heads * cfg.head_dim
                      + 2 * cfg.n_kv_heads * cfg.head_dim
                      if cfg.qkv_bias else 0))
    if cfg.family == "moe":
        per = attn_params + 2 * nrm + d * cfg.n_experts \
            + cfg.n_experts * d * cfg.d_ff * 3
        if cfg.n_shared_experts:
            per += d * (cfg.n_shared_experts * cfg.d_ff) * 3
        return int(total + cfg.n_layers * per)
    mults = 3 if cfg.act in ("silu", "swiglu") else 2
    for seg in segments(cfg):
        total += seg.count * (attn_params + d * cfg.d_ff * mults + 2 * nrm)
    return int(total)
