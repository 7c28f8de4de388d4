"""Encoder-decoder seq2seq LM (the seamless-m4t backbone).

The modality frontend (mel-spectrogram + conv codec) is a stub, as in the
JAX package: ``src_embeds`` arrives as precomputed frame embeddings (B,
S_src, d_frontend), projected into d_model.  The transformer backbone — a
bidirectional encoder and a causal decoder with cross-attention — is
whole.

``n_layers`` counts encoder + decoder layers (``n_enc_layers`` of them are
the encoder's).  Each side's blocks are stacked on a leading axis with the
JAX package's key paths (``src_proj``, ``embed``, ``enc``, ``enc_norm``,
``dec``, ``final_norm``, ``head``) and run by
:func:`repro_torch.models.scan_config.scan` in a loop.  Decode keeps two
caches a decoder layer: the self-attention KV cache, which grows with the
generated tokens, and the cross-attention K/V of the encoder memory,
computed once by the prefill.  The JAX package's five sharding
``constrain`` calls are made where it makes them, and one more on the
cross-attention K/V the prefill caches: the identity on one device, a
redistribution of DTensors on a process mesh.

``prefill`` and ``decode_step`` run under ``torch.inference_mode`` (under
``torch.no_grad`` on DTensors); the cache's ``pos`` is a 0-d int32 tensor
on the device, so a decode step reads nothing back to the host and leaves
the cache it was given as it was.  On a process mesh the cross-attention
K/V stay on the cache's shards (batch on ``data``, head_dim on
``model``): the prefill projects them straight onto those placements,
and a decode step attends over each rank's slice of head_dim
(:func:`repro_torch.models.attention.attend_by_head_dim`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.opgraph import split_generator
from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              on_shards, replicate_like)
from . import attention as attn
from .causal_lm import (_checkpointed, _constrain_act, _constrain_rows,
                        _head, _serving, _stack, _stack_init)
from .layers import (cross_entropy, dense, dense_init, embed, embed_init,
                     init_device, mlp, mlp_init, norm_apply, norm_init)
from .scan_config import scan


def _norm(cfg: ModelCfg, dev):
    return norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, device=dev)


def _attn_init(gen, cfg: ModelCfg, dev):
    return attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.param_dtype, device=dev)


def _enc_block_init(gen, cfg: ModelCfg, dev):
    g1, g2 = split_generator(gen, 2)
    return {"ln1": _norm(cfg, dev),
            "attn": _attn_init(g1, cfg, dev),
            "ln2": _norm(cfg, dev),
            "mlp": mlp_init(g2, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.param_dtype, device=dev)}


def _dec_block_init(gen, cfg: ModelCfg, dev):
    g1, g2, g3 = split_generator(gen, 3)
    return {"ln1": _norm(cfg, dev),
            "self_attn": _attn_init(g1, cfg, dev),
            "ln_x": _norm(cfg, dev),
            "cross_attn": _attn_init(g2, cfg, dev),
            "ln2": _norm(cfg, dev),
            "mlp": mlp_init(g3, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.param_dtype, device=dev)}


def init(cfg: ModelCfg, gen: torch.Generator, *,
         device=None) -> Dict[str, Any]:
    """Random parameters on ``gen``'s device (or on ``device``, as
    ``causal_lm.init``), with the JAX package's key paths and shapes (the
    values differ: carry JAX's weights with ``from_numpy_tree`` to
    compare)."""
    dev = init_device(gen, device)
    ks = split_generator(gen, 6)
    return {
        "src_proj": dense_init(ks[0], cfg.d_frontend, cfg.d_model,
                               cfg.param_dtype, device=dev),
        "embed": embed_init(ks[1], cfg.vocab_padded, cfg.d_model,
                            cfg.param_dtype, device=dev),
        "enc": _stack_init(lambda g: _enc_block_init(g, cfg, dev), ks[2],
                           cfg.n_enc_layers),
        "enc_norm": _norm(cfg, dev),
        "dec": _stack_init(lambda g: _dec_block_init(g, cfg, dev), ks[3],
                           cfg.n_dec_layers),
        "final_norm": _norm(cfg, dev),
        "head": dense_init(ks[4], cfg.d_model, cfg.vocab_padded,
                           cfg.param_dtype, scale=0.02, device=dev),
    }


def _kw(cfg: ModelCfg, rope: bool = True):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, window=None,
                rope_fraction=cfg.rope_fraction if rope else 0.0,
                rope_theta=cfg.rope_theta)


def _enc_block(cfg: ModelCfg, pl, h):
    hh = norm_apply(cfg.norm, pl["ln1"], h)
    h = h + attn.attn_train(pl["attn"], hh, causal=False, **_kw(cfg))
    hh = norm_apply(cfg.norm, pl["ln2"], h)
    return h + mlp(pl["mlp"], hh, cfg.act)


def encode(cfg: ModelCfg, params, src_embeds: torch.Tensor) -> torch.Tensor:
    """src_embeds: (B, S_src, d_frontend) -> encoder memory (B, S_src, d)."""
    x = _constrain_rows(dense(params["src_proj"], src_embeds.to(cfg.dtype)))
    block = _checkpointed(
        cfg, lambda h, pl: _constrain_act(_enc_block(cfg, pl, h)))
    x, _ = scan(lambda h, pl: (block(h, pl), None), x, params["enc"])
    return norm_apply(cfg.norm, params["enc_norm"], x)


def _dec_block(cfg: ModelCfg, pl, h, memory):
    hh = norm_apply(cfg.norm, pl["ln1"], h)
    h = h + attn.attn_train(pl["self_attn"], hh, causal=True, **_kw(cfg))
    hh = norm_apply(cfg.norm, pl["ln_x"], h)
    h = h + attn.attn_train(pl["cross_attn"], hh, causal=False, x_kv=memory,
                            **_kw(cfg, rope=False))
    hh = norm_apply(cfg.norm, pl["ln2"], h)
    return h + mlp(pl["mlp"], hh, cfg.act)


def _decoder_train(cfg: ModelCfg, params, tgt_tokens: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S_tgt, V_padded) over ``memory``."""
    x = _constrain_rows(embed(params["embed"], tgt_tokens, cfg.dtype))
    block = _checkpointed(
        cfg, lambda h, pl, m: _constrain_act(_dec_block(cfg, pl, h, m)))
    x, _ = scan(lambda h, pl: (block(h, pl, memory), None), x,
                params["dec"])
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)


def train_loss(cfg: ModelCfg, params, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: src_embeds (B, S_src, d_frontend), tokens (B, S_tgt),
    labels."""
    memory = encode(cfg, params, batch["src_embeds"])
    logits = _decoder_train(cfg, params, batch["tokens"], memory)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": replicate_like(
        torch.zeros((), dtype=torch.float32, device=ce.device), ce)}


# ---------------------------------------------------------------- serving --
def _cross_kv(cfg: ModelCfg, pl, memory):
    """The memory's cross-attention K/V (B, S_src, H_kv, hd); on DTensors
    with the batch on ``data`` and head_dim on ``model``, where the cache
    holds them (one redistribution of the projections' heads)."""
    B, Sk = memory.shape[:2]
    k = dense({"w": pl["cross_attn"]["wk"]["w"]}, memory)
    v = dense({"w": pl["cross_attn"]["wv"]["w"]}, memory)
    return tuple(constrain(t.reshape(B, Sk, cfg.n_kv_heads, cfg.head_dim),
                           ("batch", None, None, "model")) for t in (k, v))


def _cross_attn(cfg: ModelCfg, pl, hh, xk, xv):
    """Cross-attention of ``hh`` (B, S, d) against the memory's K/V: no
    mask, no RoPE.  The same operations as ``attn_train(..., x_kv=memory,
    rope_fraction=0)`` given ``_cross_kv``'s K/V, so the values equal
    the JAX package's, which computes them in both.  On DTensors q is cut
    to the K/V's shards and each rank attends over its slice of head_dim
    (:func:`~repro_torch.models.attention.attend_by_head_dim`): ``xk`` and
    ``xv`` are never gathered."""
    B, S = hh.shape[:2]
    q = dense({"w": pl["cross_attn"]["wq"]["w"]}, hh)
    if is_dtensor(q):
        rows = attn.rows_of(hh)
        q = on_shards(lambda t: t.reshape(t.shape[0], S, -1, cfg.head_dim),
                      rows, q.redistribute(q.device_mesh, rows))
        o = attn.attend_by_head_dim(q, xk, xv, rows, head_dim=cfg.head_dim)
    else:
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        o = attn.sdpa(q, xk.to(q.dtype), xv.to(q.dtype), None).reshape(
            B, S, cfg.n_heads * cfg.head_dim)
    return dense({"w": pl["cross_attn"]["wo"]["w"]}, o)


@_serving
def prefill(cfg: ModelCfg, params, src_embeds: torch.Tensor,
            tgt_tokens: torch.Tensor, cache_len: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode the source and run the decoder over a target prefix, building
    the caches: (last-position logits (B, 1, V_padded), cache)."""
    memory = encode(cfg, params, src_embeds)
    x = embed(params["embed"], tgt_tokens, cfg.dtype)
    S = tgt_tokens.shape[1]

    def body(h, pl):
        hh = norm_apply(cfg.norm, pl["ln1"], h)
        a, kvc = attn.attn_prefill(pl["self_attn"], hh, cache_len=cache_len,
                                   **_kw(cfg))
        h = h + a
        hh = norm_apply(cfg.norm, pl["ln_x"], h)
        ck, cv = _cross_kv(cfg, pl, memory)
        h = h + _cross_attn(cfg, pl, hh, ck, cv)
        hh = norm_apply(cfg.norm, pl["ln2"], h)
        h = h + mlp(pl["mlp"], hh, cfg.act)
        return h, {"k": kvc.k, "v": kvc.v, "xk": ck, "xv": cv}

    x, caches = scan(body, x, params["dec"])
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    return _head(cfg, params, x), {
        "pos": replicate_like(torch.tensor(S, dtype=torch.int32,
                                           device=x.device), x),
        "dec": _stack(caches)}


def cache_init(cfg: ModelCfg, batch: int, cache_len: int, src_len: int,
               dtype=None, *, device) -> Dict[str, Any]:
    """Empty decode caches on ``device``: ``pos`` (0-d int32) and the
    decoder's stacked ``{"k", "v"}: (n_dec, B, cache_len, H_kv, hd)`` and
    ``{"xk", "xv"}: (n_dec, B, src_len, H_kv, hd)``."""
    dtype = dtype or cfg.dtype

    def z(*shape):
        return torch.zeros((cfg.n_dec_layers,) + shape, dtype=dtype,
                           device=device)

    kv = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    xkv = (batch, src_len, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "dec": {"k": z(*kv), "v": z(*kv), "xk": z(*xkv), "xv": z(*xkv)}}


@_serving
def decode_step(cfg: ModelCfg, params, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder token (B, 1) against the self-KV cache and the fixed
    cross K/V.  Returns (logits (B, 1, V_padded), new cache); the new
    cache's ``xk`` / ``xv`` are the given cache's tensors."""
    pos = cache["pos"]
    dec = cache["dec"]
    x = _constrain_rows(embed(params["embed"], tokens, cfg.dtype))

    def body(h, xs):
        pl, c = xs["p"], xs["c"]
        hh = norm_apply(cfg.norm, pl["ln1"], h)
        a, kvc = attn.attn_decode(pl["self_attn"], hh,
                                  attn.KVCache(c["k"], c["v"]), pos,
                                  **_kw(cfg))
        h = h + a
        hh = norm_apply(cfg.norm, pl["ln_x"], h)
        h = h + _cross_attn(cfg, pl, hh, c["xk"], c["xv"])
        hh = norm_apply(cfg.norm, pl["ln2"], h)
        h = h + mlp(pl["mlp"], hh, cfg.act)
        return h, {"k": kvc.k, "v": kvc.v}

    x, kvs = scan(body, x, {"p": params["dec"], "c": dec})
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), {
        "pos": pos + 1,
        "dec": {**_stack(kvs), "xk": dec["xk"], "xv": dec["xv"]}}


def count_params(cfg: ModelCfg) -> int:
    d, V = cfg.d_model, cfg.vocab_padded
    nrm = 2 * d if cfg.norm == "layernorm" else d
    attn_p = d * cfg.n_heads * cfg.head_dim * 2 \
        + d * cfg.n_kv_heads * cfg.head_dim * 2
    mlp_mults = 3 if cfg.act in ("silu", "swiglu") else 2
    mlp_p = d * cfg.d_ff * mlp_mults
    enc = cfg.n_enc_layers * (attn_p + mlp_p + 2 * nrm)
    dec = cfg.n_dec_layers * (2 * attn_p + mlp_p + 3 * nrm)
    return int(cfg.d_frontend * d + V * d + enc + nrm + dec + nrm + d * V)
