"""Decoder-only causal LM: the dense, moe, hybrid, xlstm and vlm families.

* ``dense``  — (GQA + SwiGLU/GELU) × L (llama3, mistral-nemo, stablelm,
  granite, gpt2);
* ``moe``    — (GQA + MoE) × L (mixtral, deepseek-moe);
* ``hybrid`` — Mamba2 × L with alternating shared attention + MLP blocks
  (zamba2): groups of ``attn_every`` Mamba2 blocks, each followed by shared
  block ``g % n_shared_attn``, then a tail of Mamba2 blocks;
* ``xlstm``  — groups of ``slstm_every - 1`` mLSTM blocks, each followed by
  one sLSTM block, then a tail of mLSTM blocks (xlstm-1.3b);
* ``vlm``    — the dense LM consuming stub patch embeddings (internvl2).

The blocks' parameters are stacked on a leading axis (two for the hybrid
groups: ``(groups, attn_every, ...)``, and the xLSTM groups' mLSTM blocks
``(groups, slstm_every - 1, ...)``), as in the JAX package, so the two
packages' trees have the same key paths and shapes;
:func:`repro_torch.models.scan_config.scan` runs them in a loop.  The
encoder-decoder is :mod:`repro_torch.models.encdec`.

Entry points:
  ``init``          params (blocks stacked per segment)
  ``forward``       full-sequence logits and the auxiliary loss
  ``train_loss``    teacher-forced loss (the gspmd training step's)
  ``cache_init``    empty decode caches
  ``prefill``       prompt forward -> last-position logits + cache
  ``decode_step``   one token against a cache
  ``count_params``  analytic parameter count

``prefill`` and ``decode_step`` run under ``torch.inference_mode`` (under
``torch.no_grad`` on DTensors).  On a process mesh every family here runs
on DTensors, with the JAX package's ``constrain`` calls where it has
them (after each block or group in ``forward``, on the rows between a
prefill's blocks, none between a decode step's); what a block computes
on each rank's own rows and heads (attention, the SSD, the mLSTM's
parallel form and the sLSTM's time loop) is in its module.  The
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
from repro_torch.core.opgraph import split_generator, tree_leaves
from repro_torch.core.rad import tree_map
from repro_torch.distributed.sharding import (constrain, gather_sequence,
                                              is_dtensor, replicate_like)
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from . import xlstm as xl
from .layers import (cross_entropy, dense, dense_init, embed, embed_init,
                     init_device, mlp, mlp_init, norm_apply, norm_init)
from .scan_config import scan, unstack


class Segment(NamedTuple):
    name: str       # params/cache key
    kind: str       # dense | moe | mamba | zamba_group | mlstm | xlstm_group
    count: int      # scan trip count
    inner: int = 0  # inner layers per trip (grouped kinds)


def segments(cfg: ModelCfg) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("blocks", "dense", cfg.n_layers)]
    if cfg.family == "moe":
        return [Segment("blocks", "moe", cfg.n_layers)]
    if cfg.family == "hybrid":
        g, rem = divmod(cfg.n_layers, cfg.attn_every)
        segs = [Segment("groups", "zamba_group", g, cfg.attn_every)]
        if rem:
            segs.append(Segment("tail", "mamba", rem))
        return segs
    if cfg.family == "xlstm":
        g, rem = divmod(cfg.n_layers, cfg.slstm_every)
        segs = [Segment("groups", "xlstm_group", g, cfg.slstm_every)]
        if rem:
            segs.append(Segment("tail", "mlstm", rem))
        return segs
    raise ValueError(f"unknown family {cfg.family!r}")


def _mamba_cfg(cfg: ModelCfg) -> ssm.MambaCfg:
    d_inner = cfg.ssm_expand * cfg.d_model
    return ssm.MambaCfg(d_model=cfg.d_model, d_inner=d_inner,
                        n_heads=d_inner // cfg.ssm_head_dim,
                        head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                        chunk=cfg.ssm_chunk)


def _xlstm_cfg(cfg: ModelCfg) -> xl.XLSTMCfg:
    return xl.XLSTMCfg(d_model=cfg.d_model, n_heads=cfg.n_heads)


# ==================================================================== init ==
def _norm(cfg: ModelCfg, dev):
    return norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, device=dev)


def _dense_block_init(gen, cfg: ModelCfg, dev=None):
    dev = init_device(gen, dev)
    g1, g2 = split_generator(gen, 2)
    return {"ln1": _norm(cfg, dev),
            "attn": attn.attn_init(g1, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.param_dtype, cfg.qkv_bias, device=dev),
            "ln2": _norm(cfg, dev),
            "mlp": mlp_init(g2, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.param_dtype, device=dev)}


def _moe_block_init(gen, cfg: ModelCfg, dev):
    g1, g2 = split_generator(gen, 2)
    return {"ln1": _norm(cfg, dev),
            "attn": attn.attn_init(g1, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.param_dtype, cfg.qkv_bias, device=dev),
            "ln2": _norm(cfg, dev),
            "moe": moe_mod.moe_init(g2, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                    cfg.n_shared_experts,
                                    dtype=cfg.param_dtype, device=dev)}


def _mamba_block_init(gen, cfg: ModelCfg, dev):
    return {"ln": _norm(cfg, dev),
            "mamba": ssm.mamba_init(gen, _mamba_cfg(cfg), cfg.param_dtype,
                                    device=dev)}


def _zamba_group_init(gen, cfg: ModelCfg, dev):
    return _stack_init(lambda r: _mamba_block_init(r, cfg, dev), gen,
                       cfg.attn_every)


def _shared_attn_init(gen, cfg: ModelCfg, dev):
    """Zamba2 shared transformer block: attention + MLP (the assigned
    d_ff=14336 lives here), weights reused across invocations."""
    g1, g2 = split_generator(gen, 2)
    p = {"ln": _norm(cfg, dev),
         "attn": attn.attn_init(g1, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim,
                                cfg.param_dtype, device=dev)}
    if cfg.d_ff > 0:
        p["ln2"] = _norm(cfg, dev)
        p["mlp"] = mlp_init(g2, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.param_dtype, device=dev)
    return p


def _mlstm_block_init(gen, cfg: ModelCfg, dev):
    return {"ln": _norm(cfg, dev),
            "mlstm": xl.mlstm_init(gen, _xlstm_cfg(cfg), cfg.param_dtype,
                                   device=dev)}


def _slstm_block_init(gen, cfg: ModelCfg, dev):
    return {"ln": _norm(cfg, dev),
            "slstm": xl.slstm_init(gen, _xlstm_cfg(cfg), cfg.param_dtype,
                                   device=dev)}


def _xlstm_group_init(gen, cfg: ModelCfg, dev):
    g1, g2 = split_generator(gen, 2)
    return {"m": _stack_init(lambda r: _mlstm_block_init(r, cfg, dev), g1,
                             cfg.slstm_every - 1),
            "s": _slstm_block_init(g2, cfg, dev)}


_BLOCK_INIT = {"dense": _dense_block_init, "moe": _moe_block_init,
               "mamba": _mamba_block_init, "zamba_group": _zamba_group_init,
               "mlstm": _mlstm_block_init, "xlstm_group": _xlstm_group_init}


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


def init(cfg: ModelCfg, gen: torch.Generator, *,
         device=None) -> Dict[str, Any]:
    """Random parameters on ``gen``'s device (or on ``device``: ``"meta"``
    with a CPU generator gives the abstract tree), with the JAX package's
    key paths and shapes (the values differ: torch cannot draw
    ``jax.random``'s numbers; carry JAX's weights with ``from_numpy_tree``
    to compare)."""
    dev = init_device(gen, device)
    ks = split_generator(gen, 8)
    params: Dict[str, Any] = {
        "embed": embed_init(ks[0], cfg.vocab_padded, cfg.d_model,
                            cfg.param_dtype, device=dev),
        "final_norm": _norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(ks[1], cfg.d_model, cfg.vocab_padded,
                                    cfg.param_dtype, scale=0.02, device=dev)
    if cfg.rope_fraction == 0.0:
        params["pos_embed"] = embed_init(ks[2], cfg.max_seq, cfg.d_model,
                                         cfg.param_dtype, device=dev)
    if cfg.n_prefix > 0:
        params["prefix_proj"] = dense_init(ks[3], cfg.d_frontend, cfg.d_model,
                                           cfg.param_dtype, device=dev)
    segs = segments(cfg)
    for seg, g in zip(segs, split_generator(ks[4], len(segs))):
        params[seg.name] = _stack_init(
            lambda r: _BLOCK_INIT[seg.kind](r, cfg, dev), g, seg.count)
    if cfg.family == "hybrid":
        params["shared_attn"] = _stack_init(
            lambda r: _shared_attn_init(r, cfg, dev), ks[5],
            max(cfg.n_shared_attn, 1))
    return params


# ================================================================ caches ==
def cache_init(cfg: ModelCfg, batch: int, cache_len: int, dtype=None, *,
               device) -> Dict[str, Any]:
    """Empty decode caches on ``device``: ``pos`` (0-d int32); a dense or
    moe segment's stacked ``{"k", "v"}: (n_layers, B, cache_len, H_kv,
    hd)``; a mamba segment's stacked ``{"h", "conv"}`` states (``(groups,
    attn_every, B, ...)`` for the hybrid groups, whose shared blocks' KV
    caches are ``groups_attn``); an mlstm segment's stacked ``{"C", "n",
    "m", "conv"}`` states, and the xLSTM groups' ``{"m": those states
    (groups, slstm_every - 1, B, ...), "s": the sLSTM's {"c", "n", "h",
    "m"} (groups, B, nh, hd)}`` (``m`` in fp32 at -1e30; no KV, so
    ``cache_len`` goes unused, as in JAX)."""
    dtype = dtype or cfg.dtype
    out: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n):
        shape = (n, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    def mamba_state(*lead):
        mc = _mamba_cfg(cfg)
        return {"h": zeros(*lead, batch, mc.n_heads, mc.d_state,
                           mc.head_dim),
                "conv": zeros(*lead, batch, mc.conv_width - 1,
                              mc.d_inner + 2 * mc.d_state)}

    def m_fp32(*shape):
        return torch.full(shape, -1e30, dtype=torch.float32, device=device)

    def mlstm_state(*lead):
        xc = _xlstm_cfg(cfg)
        nh, hd = xc.n_heads, xc.head_dim_m
        return {"C": zeros(*lead, batch, nh, hd, hd),
                "n": zeros(*lead, batch, nh, hd),
                "m": m_fp32(*lead, batch, nh),
                "conv": zeros(*lead, batch, xc.conv_width - 1, xc.d_inner_m)}

    def slstm_state(n):
        shape = (n, batch, cfg.n_heads, _xlstm_cfg(cfg).head_dim_s)
        return {"c": zeros(*shape), "n": zeros(*shape), "h": zeros(*shape),
                "m": m_fp32(*shape)}

    for seg in segments(cfg):
        if seg.kind in ("dense", "moe"):
            out[seg.name] = kv(seg.count)
        elif seg.kind == "mamba":
            out[seg.name] = mamba_state(seg.count)
        elif seg.kind == "zamba_group":
            out[seg.name] = mamba_state(seg.count, seg.inner)
            out[seg.name + "_attn"] = kv(seg.count)
        elif seg.kind == "mlstm":
            out[seg.name] = mlstm_state(seg.count)
        else:                                   # xlstm_group
            out[seg.name] = {"m": mlstm_state(seg.count, seg.inner - 1),
                             "s": slstm_state(seg.count)}
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


def _mamba_block(cfg, p, x):
    return x + ssm.mamba_train(p["mamba"],
                               norm_apply(cfg.norm, p["ln"], x),
                               _mamba_cfg(cfg))


def _mamba_block_prefill(cfg, p, x):
    h = norm_apply(cfg.norm, p["ln"], x)
    y, st = ssm.mamba_prefill(p["mamba"], h, _mamba_cfg(cfg))
    return x + y, {"h": st.h, "conv": st.conv}


def _mamba_block_decode(cfg, p, x_t, st):
    h = norm_apply(cfg.norm, p["ln"], x_t)
    y, st = ssm.mamba_decode_step(p["mamba"], h,
                                  ssm.MambaState(st["h"], st["conv"]),
                                  _mamba_cfg(cfg))
    return x_t + y, {"h": st.h, "conv": st.conv}


def _mlstm_block(cfg, p, x):
    return x + xl.mlstm_block(p["mlstm"], xl.block_norm(cfg.norm, p["ln"], x),
                              _xlstm_cfg(cfg))


def _mlstm_block_prefill(cfg, p, x):
    h = xl.block_norm(cfg.norm, p["ln"], x)
    y, st = xl.mlstm_prefill(p["mlstm"], h, _xlstm_cfg(cfg))
    return x + y, st._asdict()


def _mlstm_block_decode(cfg, p, x_t, st):
    h = xl.block_norm(cfg.norm, p["ln"], x_t)
    y, st = xl.mlstm_decode_step(p["mlstm"], h, xl.MLSTMState(**st),
                                 _xlstm_cfg(cfg))
    return x_t + y, st._asdict()


def _slstm_block(cfg, p, x):
    return x + xl.slstm_block(p["slstm"], xl.block_norm(cfg.norm, p["ln"], x),
                              _xlstm_cfg(cfg))


def _slstm_block_prefill(cfg, p, x):
    """The sLSTM block over the prompt, written out as in the JAX package's
    prefill (norm, the cell scan, the FFN, the residual), with the state
    after the last step."""
    h = xl.block_norm(cfg.norm, p["ln"], x)
    y, st = xl.slstm_seq(p["slstm"], h, _xlstm_cfg(cfg))
    return x + xl.slstm_block_ffn(p["slstm"], y), st._asdict()


def _slstm_block_decode(cfg, p, x_t, st):
    h = xl.block_norm(cfg.norm, p["ln"], x_t)
    y, st = xl.slstm_decode_step(p["slstm"], h, xl.SLSTMState(**st),
                                 _xlstm_cfg(cfg))
    return x_t + y, st._asdict()


def _shared_mlp(cfg, sp, x):
    if "mlp" not in sp:
        return x
    h = norm_apply(cfg.norm, sp["ln2"], x)
    return x + mlp(sp["mlp"], h, cfg.act)


def _shared_attn_apply(cfg, sp, x, window):
    h = norm_apply(cfg.norm, sp["ln"], x)
    x = x + attn.attn_train(sp["attn"], h, causal=True,
                            **_attn_kwargs(cfg, window))
    return _shared_mlp(cfg, sp, x)


def _shared_attn_prefill(cfg, sp, x, window, cache_len):
    h = norm_apply(cfg.norm, sp["ln"], x)
    a, kvc = attn.attn_prefill(sp["attn"], h, cache_len=cache_len,
                               **_attn_kwargs(cfg, window))
    return _shared_mlp(cfg, sp, x + a), {"k": kvc.k, "v": kvc.v}


def _shared_attn_decode(cfg, sp, x, kv, pos, window):
    h = norm_apply(cfg.norm, sp["ln"], x)
    a, kvc = attn.attn_decode(sp["attn"], h, attn.KVCache(kv["k"], kv["v"]),
                              pos, **_attn_kwargs(cfg, window))
    return _shared_mlp(cfg, sp, x + a), {"k": kvc.k, "v": kvc.v}


def _stack(ys, lead: Optional[Tuple[int, ...]] = None):
    """Per-layer trees -> one tree of stacked leaves (scan's ``ys``); with
    ``lead``, the stacked axis is split into those axes (the hybrid groups'
    ``(groups, attn_every)``), so nested stacks are built in one copy."""
    if lead is None:
        return tree_map(lambda *ts: torch.stack(ts), *ys)
    return tree_map(lambda *ts: torch.stack(ts).unflatten(0, lead), *ys)


def blocks_prefill(cfg: ModelCfg, kind: str, p_seg, x: torch.Tensor,
                   window: Optional[int], cache_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt forward through a run of stacked ``kind`` blocks (dense, moe,
    mamba or mlstm): the output hiddens and the run's stacked cache
    (``{"k", "v"}``, or the recurrent states)."""
    x, ys = _run_prefill(cfg, kind, p_seg, x, window, cache_len)
    return x, _stack(ys)


def _run_prefill(cfg, kind, p_seg, x, window, cache_len):
    def body(h, pl):
        if kind == "dense":
            h2, kvc = _dense_block_prefill(cfg, pl, h, window, cache_len)
        elif kind == "moe":
            h2, _, kvc = _moe_block_prefill(cfg, pl, h, window, cache_len)
        elif kind == "mlstm":
            return _mlstm_block_prefill(cfg, pl, h)
        else:
            return _mamba_block_prefill(cfg, pl, h)
        return _constrain_rows(h2), {"k": kvc.k, "v": kvc.v}
    return scan(body, x, p_seg)


def blocks_decode(cfg: ModelCfg, kind: str, p_seg, x: torch.Tensor,
                  cache, pos: torch.Tensor, window: Optional[int]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through a run of stacked ``kind`` blocks against the run's
    stacked cache; returns the hiddens and a new stacked cache."""
    x, ys = _run_decode(cfg, kind, p_seg, x, cache, pos, window)
    return x, _stack(ys)


def _run_decode(cfg, kind, p_seg, x, cache, pos, window):
    if kind in ("mamba", "mlstm"):
        block = _mamba_block_decode if kind == "mamba" else _mlstm_block_decode

        def body(h, xs):
            h2, st = block(cfg, xs["p"], h[:, 0, :], xs["c"])
            return h2[:, None, :], st
    else:
        block = _dense_block_decode if kind == "dense" else _moe_block_decode

        def body(h, xs):
            h2, kvc = block(cfg, xs["p"], h, attn.KVCache(xs["c"]["k"],
                                                          xs["c"]["v"]),
                            pos, window)
            return h2, {"k": kvc.k, "v": kvc.v}
    return scan(body, x, {"p": p_seg, "c": cache})


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
        pos = replicate_like(torch.arange(pos0, pos0 + S,
                                          device=tokens.device), tokens)
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
    """Full-sequence forward.  Returns (logits, aux_loss).  The sharding
    ``constrain`` calls are the JAX package's: the identity on one device,
    a redistribution of DTensors on a process mesh."""
    window = window if window is not None else cfg.window
    x = _embed_tokens(cfg, params, tokens, prefix_embeds)
    x = _constrain_act(x)
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    for seg in segments(cfg):
        p_seg = params[seg.name]
        if seg.kind == "moe":
            block = _checkpointed(
                cfg, lambda h, pl: _constrain_aux(_moe_block(cfg, pl, h,
                                                             window)))
            x, auxs = scan(block, x, p_seg)
            aux = aux + torch.stack(auxs).sum()
        elif seg.kind == "zamba_group":
            shared = _shared_blocks(params, seg.count)

            def group(h, pl_g, sp):
                h, _ = scan(lambda h2, pl: (_mamba_block(cfg, pl, h2), None),
                            h, pl_g)
                return _constrain_act(_shared_attn_apply(cfg, sp, h, window))
            block = _checkpointed(cfg, group)
            for g, pl_g in enumerate(unstack(p_seg)):
                x = block(x, pl_g, shared[g % len(shared)])
        elif seg.kind == "xlstm_group":
            def group(h, pl_g):
                h, _ = scan(lambda h2, pl: (_mlstm_block(cfg, pl, h2), None),
                            h, pl_g["m"])
                return _constrain_act(_slstm_block(cfg, pl_g["s"], h))
            block = _checkpointed(cfg, group)
            for pl_g in unstack(p_seg):
                x = block(x, pl_g)
        else:
            fn = {"dense": lambda h, pl: _constrain_act(
                      _dense_block(cfg, pl, h, window)),
                  "mamba": lambda h, pl: _mamba_block(cfg, pl, h),
                  "mlstm": lambda h, pl: _mlstm_block(cfg, pl, h)}[seg.kind]
            block = _checkpointed(cfg, fn)
            x, _ = scan(lambda h, pl: (block(h, pl), None), x, p_seg)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return constrain(_head(cfg, params, x), ("batch", None, "vocab")), aux


def _constrain_act(h):
    return constrain(h, ("batch", "act_seq", None))


def _constrain_rows(h):
    """The serving paths' constraint: activations sharded over batch."""
    return constrain(h, ("batch", None, None))


def _constrain_aux(h_aux):
    return _constrain_act(h_aux[0]), h_aux[1]


def _shared_blocks(params, n_groups: int) -> List[Dict[str, Any]]:
    """The hybrid's shared blocks that ``n_groups`` groups run, each a view
    of ``shared_attn``; group ``g`` runs block ``g % len(...)``.  One
    ``unbind`` a call, not a ``_pick`` a group, for the reason ``_pick``
    gives.  Blocks no group runs are sliced off first: autograd fills the
    gradient of an unused ``unbind`` output with a plain tensor, which
    cannot stack with DTensors (their gradient is zero all the same)."""
    sp = params["shared_attn"]
    if n_groups < tree_leaves(sp)[0].shape[0]:
        sp = tree_map(lambda a: a[:n_groups], sp)
    return unstack(sp)


def _head(cfg, params, x):
    if cfg.tie_embeddings:
        logits = gather_sequence(x) @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = dense(params["head"], x)
    if cfg.vocab_padded != cfg.vocab:
        # mask padding classes so the softmax is over the true vocabulary
        valid = replicate_like(
            torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab, x)
        logits = torch.where(valid, logits, -1e30)
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
def _serving(fn):
    """``fn`` under ``torch.inference_mode``, or under ``torch.no_grad`` when
    the parameters are DTensors: DTensor's views set a version counter,
    which inference tensors do not have."""
    @functools.wraps(fn)
    def wrapped(cfg, params, *args, **kwargs):
        sharded = is_dtensor(next(iter(tree_leaves(params)), None))
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(cfg, params, *args, **kwargs)
    return wrapped


@_serving
def prefill(cfg: ModelCfg, params, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward over the prompt, returning (last-position logits, cache)."""
    window = window if window is not None else cfg.window
    x = _constrain_rows(_embed_tokens(cfg, params, tokens, prefix_embeds))
    S = x.shape[1]
    cache_len = cache_len or S
    cache: Dict[str, Any] = {"pos": replicate_like(
        torch.tensor(S, dtype=torch.int32, device=x.device), x)}
    for seg in segments(cfg):
        p_seg = params[seg.name]
        if seg.kind == "xlstm_group":
            msts, ssts = [], []
            for pl_g in unstack(p_seg):
                x, st = _run_prefill(cfg, "mlstm", pl_g["m"], x, window,
                                     cache_len)
                x, s_st = _slstm_block_prefill(cfg, pl_g["s"], x)
                x = _constrain_rows(x)
                msts += st
                ssts.append(s_st)
            cache[seg.name] = {"m": _stack(msts, (seg.count, seg.inner - 1)),
                               "s": _stack(ssts)}
            continue
        if seg.kind != "zamba_group":
            x, cache[seg.name] = blocks_prefill(cfg, seg.kind, p_seg, x,
                                                window, cache_len)
            continue
        shared = _shared_blocks(params, seg.count)
        sts, kvs = [], []
        for g, pl_g in enumerate(unstack(p_seg)):
            x, st = _run_prefill(cfg, "mamba", pl_g, x, window, cache_len)
            x, kv = _shared_attn_prefill(cfg, shared[g % len(shared)], x,
                                         window, cache_len)
            x = _constrain_rows(x)
            sts += st
            kvs.append(kv)
        cache[seg.name] = _stack(sts, (seg.count, seg.inner))
        cache[seg.name + "_attn"] = _stack(kvs)
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    return _head(cfg, params, x), cache


# ================================================================ decode ==
@_serving
def decode_step(cfg: ModelCfg, params, cache: Dict[str, Any],
                tokens: torch.Tensor, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) int; cache from :func:`cache_init`
    or :func:`prefill` (not modified).  Returns (logits (B,1,V), cache)."""
    window = window if window is not None else cfg.window
    pos = cache["pos"]
    x = _constrain_rows(_embed_step(cfg, params, tokens, pos))
    new_cache: Dict[str, Any] = {"pos": pos + 1}
    for seg in segments(cfg):
        p_seg, c_seg = params[seg.name], cache[seg.name]
        if seg.kind == "xlstm_group":
            msts, ssts = [], []
            for xs in unstack({"p": p_seg, "c": c_seg}):
                x, st = _run_decode(cfg, "mlstm", xs["p"]["m"], x,
                                    xs["c"]["m"], pos, window)
                h, s_st = _slstm_block_decode(cfg, xs["p"]["s"], x[:, 0, :],
                                              xs["c"]["s"])
                x = h[:, None, :]
                msts += st
                ssts.append(s_st)
            new_cache[seg.name] = {
                "m": _stack(msts, (seg.count, seg.inner - 1)),
                "s": _stack(ssts)}
            continue
        if seg.kind != "zamba_group":
            x, new_cache[seg.name] = blocks_decode(cfg, seg.kind, p_seg, x,
                                                   c_seg, pos, window)
            continue
        shared = _shared_blocks(params, seg.count)
        sts, kvs = [], []
        for g, xs in enumerate(unstack({"p": p_seg, "c": c_seg,
                                        "kv": cache[seg.name + "_attn"]})):
            x, st = _run_decode(cfg, "mamba", xs["p"], x, xs["c"], pos,
                                window)
            x, kv = _shared_attn_decode(cfg, shared[g % len(shared)], x,
                                        xs["kv"], pos, window)
            sts += st
            kvs.append(kv)
        new_cache[seg.name] = _stack(sts, (seg.count, seg.inner))
        new_cache[seg.name + "_attn"] = _stack(kvs)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), new_cache


# ============================================================== analytics ==
def count_params(cfg: ModelCfg) -> int:
    """Analytic parameter count (held against ``init`` and against the JAX
    package in the tests)."""
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
    mlp_params = d * cfg.d_ff * (3 if cfg.act in ("silu", "swiglu") else 2)

    def mamba_params():
        mc = _mamba_cfg(cfg)
        di, ds, nh = mc.d_inner, mc.d_state, mc.n_heads
        return (d * (2 * di + 2 * ds + nh)           # in_proj
                + (di + 2 * ds) * (mc.conv_width + 1) # conv w + b
                + 3 * nh + di                         # A_log, D, dt_bias, norm
                + di * d)                             # out_proj

    def mlstm_params():
        c = _xlstm_cfg(cfg)
        di, hd = c.d_inner_m, c.head_dim_m
        return (d * 2 * di + di * (c.conv_width + 1)
                + 3 * cfg.n_heads * hd * hd
                + di * 2 * cfg.n_heads + di + di * d + cfg.n_heads)

    def slstm_params():
        c = _xlstm_cfg(cfg)
        hd = c.head_dim_s
        d_ff = xl._slstm_ffn_width(c)
        return (d * 4 * d + 4 * cfg.n_heads * hd * hd + 4 * d + 2 * d
                + d * d_ff * 2 + d_ff * d + cfg.n_heads * hd)

    for seg in segments(cfg):
        if seg.kind == "dense":
            total += seg.count * (attn_params + mlp_params + 2 * nrm)
        elif seg.kind == "moe":
            per = attn_params + 2 * nrm + d * cfg.n_experts \
                + cfg.n_experts * d * cfg.d_ff * 3
            if cfg.n_shared_experts:
                per += d * (cfg.n_shared_experts * cfg.d_ff) * 3
            total += seg.count * per
        elif seg.kind == "mamba":
            total += seg.count * (mamba_params() + nrm)
        elif seg.kind == "zamba_group":
            total += seg.count * seg.inner * (mamba_params() + nrm)
        elif seg.kind == "mlstm":
            total += seg.count * (mlstm_params() + nrm)
        else:                                     # xlstm_group
            total += seg.count * ((seg.inner - 1) * (mlstm_params() + nrm)
                                  + slstm_params() + nrm)
    if cfg.family == "hybrid":
        per_shared = attn_params + nrm
        if cfg.d_ff > 0:
            per_shared += mlp_params + nrm
        total += max(cfg.n_shared_attn, 1) * per_shared
    return int(total)
