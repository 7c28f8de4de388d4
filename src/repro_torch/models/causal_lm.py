"""Decoder-only causal LM: the dense, moe and vlm families.

* ``dense`` — (GQA + SwiGLU/GELU) × L (llama3, mistral-nemo, stablelm,
  granite, gpt2);
* ``moe``   — (GQA + MoE) × L (mixtral, deepseek-moe);
* ``vlm``   — the dense LM consuming stub patch embeddings (internvl2).

The blocks' parameters are stacked on a leading axis of ``n_layers``, as
in the JAX package, so the two packages' trees have the same key paths and
shapes; :func:`repro_torch.models.scan_config.scan` runs them in a loop.
The hybrid and xLSTM families come with ROADMAP Q1.3.

Entry points:
  ``init``          params (blocks stacked per segment)
  ``forward``       full-sequence logits and the auxiliary loss
  ``train_loss``    teacher-forced loss (the gspmd training step's)
  ``cache_init``    empty decode caches
  ``prefill``       prompt forward -> last-position logits + KV cache
  ``decode_step``   one token against a cache
  ``count_params``  analytic parameter count

``prefill`` and ``decode_step`` run under ``torch.inference_mode``.  The
cache's ``pos`` is a 0-d int32 tensor on the cache's device, as in JAX, so
a decode step reads nothing back to the host.  The serving stages
(:mod:`repro_torch.serving.stages`) run the same per-segment loops
(:func:`blocks_prefill`, :func:`blocks_decode`) over slices of the stack,
which is what makes a chain of stages bit-identical to this model.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.opgraph import split_generator
from repro_torch.core.rad import tree_map
from . import attention as attn
from . import moe as moe_mod
from .layers import (cross_entropy, dense, dense_init, embed, embed_init,
                     mlp, mlp_init, norm_apply, norm_init)
from .scan_config import scan

_NOT_PORTED = {"hybrid": "ROADMAP Q1.3", "xlstm": "ROADMAP Q1.3"}


class Segment(NamedTuple):
    name: str       # params/cache key
    kind: str       # dense | moe (the kinds ported)
    count: int      # scan trip count
    inner: int = 0  # inner layers per trip (grouped kinds)


def segments(cfg: ModelCfg) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("blocks", "dense", cfg.n_layers)]
    if cfg.family == "moe":
        return [Segment("blocks", "moe", cfg.n_layers)]
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


def _moe_block_init(gen, cfg: ModelCfg):
    g1, g2 = split_generator(gen, 2)
    dev = gen.device
    return {"ln1": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
            "attn": attn.attn_init(g1, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.param_dtype, cfg.qkv_bias),
            "ln2": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
            "moe": moe_mod.moe_init(g2, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                    cfg.n_shared_experts,
                                    dtype=cfg.param_dtype)}


_BLOCK_INIT = {"dense": _dense_block_init, "moe": _moe_block_init}


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
            lambda r: _BLOCK_INIT[seg.kind](r, cfg), g, seg.count)
    return params


# ================================================================ caches ==
def cache_init(cfg: ModelCfg, batch: int, cache_len: int, dtype=None, *,
               device) -> Dict[str, Any]:
    """Empty decode caches on ``device``: ``pos`` (0-d int32) and each
    segment's stacked ``{"k", "v"}: (n_layers, B, cache_len, H_kv, hd)``."""
    dtype = dtype or cfg.dtype
    out: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}
    for seg in segments(cfg):
        shape = (seg.count, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        out[seg.name] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
    return out


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


def _dense_block_prefill(cfg, p, x, window, cache_len):
    h = norm_apply(cfg.norm, p["ln1"], x)
    a, kvc = attn.attn_prefill(p["attn"], h, cache_len=cache_len,
                               **_attn_kwargs(cfg, window))
    x = x + a
    h = norm_apply(cfg.norm, p["ln2"], x)
    return x + mlp(p["mlp"], h, cfg.act), kvc


def _dense_block_decode(cfg, p, x, kvc, pos, window):
    h = norm_apply(cfg.norm, p["ln1"], x)
    a, kvc = attn.attn_decode(p["attn"], h, kvc, pos,
                              **_attn_kwargs(cfg, window))
    x = x + a
    h = norm_apply(cfg.norm, p["ln2"], x)
    return x + mlp(p["mlp"], h, cfg.act), kvc


def _moe_ffn(cfg, p, h):
    return moe_mod.moe_apply(p["moe"], h, cfg.top_k, cfg.moe_impl,
                             cfg.capacity_factor)


def _moe_block(cfg, p, x, window):
    h = norm_apply(cfg.norm, p["ln1"], x)
    x = x + attn.attn_train(p["attn"], h, causal=True,
                            **_attn_kwargs(cfg, window))
    h = norm_apply(cfg.norm, p["ln2"], x)
    y, aux = _moe_ffn(cfg, p, h)
    return x + y, aux


def _moe_block_prefill(cfg, p, x, window, cache_len):
    h = norm_apply(cfg.norm, p["ln1"], x)
    a, kvc = attn.attn_prefill(p["attn"], h, cache_len=cache_len,
                               **_attn_kwargs(cfg, window))
    x = x + a
    h = norm_apply(cfg.norm, p["ln2"], x)
    y, aux = _moe_ffn(cfg, p, h)
    return x + y, aux, kvc


def _moe_block_decode(cfg, p, x, kvc, pos, window):
    h = norm_apply(cfg.norm, p["ln1"], x)
    a, kvc = attn.attn_decode(p["attn"], h, kvc, pos,
                              **_attn_kwargs(cfg, window))
    x = x + a
    h = norm_apply(cfg.norm, p["ln2"], x)
    y, _ = _moe_ffn(cfg, p, h)
    return x + y, kvc


def _stack(ys):
    """Per-layer trees -> one tree of stacked leaves (scan's ``ys``)."""
    return tree_map(lambda *ts: torch.stack(ts), *ys)


def blocks_prefill(cfg: ModelCfg, kind: str, p_seg, x: torch.Tensor,
                   window: Optional[int], cache_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt forward through a run of stacked ``kind`` blocks: the output
    hiddens and the run's stacked ``{"k", "v"}`` cache."""
    def body(h, pl):
        if kind == "dense":
            h2, kvc = _dense_block_prefill(cfg, pl, h, window, cache_len)
        else:
            h2, _, kvc = _moe_block_prefill(cfg, pl, h, window, cache_len)
        return h2, {"k": kvc.k, "v": kvc.v}
    x, kvs = scan(body, x, p_seg)
    return x, _stack(kvs)


def blocks_decode(cfg: ModelCfg, kind: str, p_seg, x: torch.Tensor,
                  kv: Dict[str, torch.Tensor], pos: torch.Tensor,
                  window: Optional[int]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through a run of stacked ``kind`` blocks against the run's
    stacked cache ``kv``; returns the hiddens and a new stacked cache."""
    block = _dense_block_decode if kind == "dense" else _moe_block_decode

    def body(h, xs):
        h2, kvc = block(cfg, xs["p"], h, attn.KVCache(xs["c"]["k"],
                                                      xs["c"]["v"]),
                        pos, window)
        return h2, {"k": kvc.k, "v": kvc.v}
    x, kvs = scan(body, x, {"p": p_seg, "c": kv})
    return x, _stack(kvs)


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


def _embed_step(cfg: ModelCfg, params, tokens, pos):
    """Embedding of one decode step's tokens (B, 1) at position ``pos``, a
    0-d tensor on the device."""
    x = embed(params["embed"], tokens, cfg.dtype)
    if cfg.rope_fraction == 0.0:
        x = x + embed(params["pos_embed"], pos[None], cfg.dtype)[None]
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
    for seg in segments(cfg):
        if seg.kind == "dense":
            block = _checkpointed(
                cfg, lambda h, pl: _dense_block(cfg, pl, h, window))
            x, _ = scan(lambda h, pl: (block(h, pl), None), x,
                        params[seg.name])
        else:
            block = _checkpointed(
                cfg, lambda h, pl: _moe_block(cfg, pl, h, window))
            x, auxs = scan(block, x, params[seg.name])
            aux = aux + torch.stack(auxs).sum()
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


# =============================================================== prefill ==
@torch.inference_mode()
def prefill(cfg: ModelCfg, params, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward over the prompt, returning (last-position logits, cache)."""
    window = window if window is not None else cfg.window
    x = _embed_tokens(cfg, params, tokens, prefix_embeds)
    S = x.shape[1]
    cache_len = cache_len or S
    cache: Dict[str, Any] = {
        "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    for seg in segments(cfg):
        x, cache[seg.name] = blocks_prefill(cfg, seg.kind, params[seg.name],
                                            x, window, cache_len)
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    return _head(cfg, params, x), cache


# ================================================================ decode ==
@torch.inference_mode()
def decode_step(cfg: ModelCfg, params, cache: Dict[str, Any],
                tokens: torch.Tensor, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) int; cache from :func:`cache_init`
    or :func:`prefill` (not modified).  Returns (logits (B,1,V), cache)."""
    window = window if window is not None else cfg.window
    pos = cache["pos"]
    x = _embed_step(cfg, params, tokens, pos)
    new_cache: Dict[str, Any] = {"pos": pos + 1}
    for seg in segments(cfg):
        x, new_cache[seg.name] = blocks_decode(
            cfg, seg.kind, params[seg.name], x, cache[seg.name], pos, window)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), new_cache


# ============================================================== analytics ==
def count_params(cfg: ModelCfg) -> int:
    """Analytic parameter count (held against ``init`` and against the JAX
    package in the tests).  The hybrid and xLSTM counts need their block
    configs (ROADMAP Q1.3) and raise."""
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
