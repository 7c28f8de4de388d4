"""Grouped-query attention with train / prefill / decode paths.

GQA with arbitrary (n_heads, n_kv_heads) — MHA when equal — causal or
bidirectional masking, an optional sliding window, RoPE where the config
asks for it, and a KV cache for prefill (fill) and decode (one-token
append).

Layout conventions (the JAX package's): activations (B, S, d); q/k/v
(B, S, H, hd); KV cache (B, S_max, H_kv, hd).  Scores and softmax run in
fp32.  The decode path is functional, as in JAX: it returns a new cache
(an out-of-place ``index_copy`` at ``pos``) and never writes into the
caller's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from .layers import apply_rope, dense, dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, H_kv, hd)
    v: torch.Tensor     # (B, S_max, H_kv, hd)


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, dtype=torch.float32,
              qkv_bias: bool = False) -> Dict[str, Any]:
    gq, gk, gv, go = split_generator(gen, 4)
    p = {"wq": dense_init(gq, d, n_heads * head_dim, dtype),
         "wk": dense_init(gk, d, n_kv * head_dim, dtype),
         "wv": dense_init(gv, d, n_kv * head_dim, dtype),
         "wo": dense_init(go, n_heads * head_dim, d, dtype,
                          scale=1.0 / math.sqrt(n_heads * head_dim))}
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros(n_heads * head_dim, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(n_kv * head_dim, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(n_kv * head_dim, dtype=dtype, device=dev)
    return p


def _project_qkv(p, x_q, x_kv, n_heads, n_kv, head_dim):
    B, Sq = x_q.shape[:2]
    Skv = x_kv.shape[1]
    q = dense({"w": p["wq"]["w"]}, x_q)
    k = dense({"w": p["wk"]["w"]}, x_kv)
    v = dense({"w": p["wv"]["w"]}, x_kv)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, Sq, n_heads, head_dim),
            k.reshape(B, Skv, n_kv, head_dim),
            v.reshape(B, Skv, n_kv, head_dim))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor],
         scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention without materializing expanded KV.

    q: (B,Sq,H,hd); k/v: (B,Skv,Hkv,hd) with H = g·Hkv; mask broadcastable
    to (B,1/H,Sq,Skv) (True = attend).  The query heads are reshaped into
    (Hkv, g) groups and contracted against the unexpanded KV."""
    B, Sq, H, hd = q.shape
    hkv = k.shape[2]
    g = H // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) * scale
    if mask is not None:
        # mask comes in as (B,1,Sq,Skv)-ish; insert the group axis
        m = mask.unsqueeze(2) if mask.dim() == 4 else mask
        scores = torch.where(m, scores, scores.new_full((), NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def make_mask(Sq: int, Skv: int, causal: bool, window: Optional[int],
              q_offset: int = 0, *, device) -> Optional[torch.Tensor]:
    """(1,1,Sq,Skv) boolean mask.  ``q_offset`` shifts query positions (for
    prefill continuation); ``window`` keeps keys within [pos-window+1, pos]."""
    if not causal and window is None:
        return None
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Skv, device=device)
    rel = qpos[:, None] - kpos[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= rel >= 0
    if window is not None:
        m &= rel < window
    return m[None, None]


def attn_train(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
               causal: bool = True, window: Optional[int] = None,
               rope_fraction: float = 1.0, rope_theta: float = 10_000.0,
               x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training / encoder).  ``x_kv`` switches to
    cross-attention (both sides get positions of their own sequence)."""
    src = x if x_kv is None else x_kv
    q, k, v = _project_qkv(p, x, src, n_heads, n_kv, head_dim)
    if rope_fraction > 0:
        qpos = torch.arange(x.shape[1], device=x.device)[None]
        kpos = torch.arange(src.shape[1], device=x.device)[None]
        q = apply_rope(q, qpos, rope_fraction, rope_theta)
        k = apply_rope(k, kpos, rope_fraction, rope_theta)
    mask = make_mask(x.shape[1], src.shape[1], causal and x_kv is None,
                     window, device=x.device)
    out = sdpa(q, k, v, mask)
    B, S = x.shape[:2]
    return dense({"w": p["wo"]["w"]}, out.reshape(B, S, n_heads * head_dim))


def attn_prefill(p, x: torch.Tensor, *, n_heads: int, n_kv: int,
                 head_dim: int, cache_len: int, window: Optional[int] = None,
                 rope_fraction: float = 1.0, rope_theta: float = 10_000.0
                 ) -> Tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt, emitting a KV cache of cache_len
    (>= S; right-padded with zeros)."""
    B, S = x.shape[:2]
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv, head_dim)
    if rope_fraction > 0:
        pos = torch.arange(S, device=x.device)[None]
        q = apply_rope(q, pos, rope_fraction, rope_theta)
        k = apply_rope(k, pos, rope_fraction, rope_theta)
    mask = make_mask(S, S, True, window, device=x.device)
    out = sdpa(q, k, v, mask)
    pad = (0, 0, 0, 0, 0, cache_len - S)     # the sequence axis, at the end
    cache = KVCache(k=F.pad(k, pad), v=F.pad(v, pad))
    return (dense({"w": p["wo"]["w"]}, out.reshape(B, S, n_heads * head_dim)),
            cache)


def attn_decode(p, x: torch.Tensor, cache: KVCache, pos: torch.Tensor, *,
                n_heads: int, n_kv: int, head_dim: int,
                window: Optional[int] = None,
                rope_fraction: float = 1.0, rope_theta: float = 10_000.0
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B, 1, d); ``pos`` a 0-d int32 tensor on the
    cache's device — the index of this token; the cache holds positions
    [0, pos).  The mask and the write position come from ``pos`` on the
    device, so a step reads nothing back to the host."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv, head_dim)
    if rope_fraction > 0:
        pvec = pos.reshape(1, 1)
        q = apply_rope(q, pvec, rope_fraction, rope_theta)
        k = apply_rope(k, pvec, rope_fraction, rope_theta)
    at = pos.reshape(1).to(torch.int64)
    new_k = cache.k.index_copy(1, at, k.to(cache.k.dtype))
    new_v = cache.v.index_copy(1, at, v.to(cache.v.dtype))
    kpos = torch.arange(new_k.shape[1], device=x.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    mask = valid[None, None, None, :]      # (1,1,1,S_max)
    out = sdpa(q, new_k.to(q.dtype), new_v.to(q.dtype), mask)
    y = dense({"w": p["wo"]["w"]}, out.reshape(B, 1, n_heads * head_dim))
    return y, KVCache(k=new_k, v=new_v)


def attn_flops(tokens: int, kv_tokens: int, d: int, n_heads: int, n_kv: int,
               head_dim: int) -> float:
    """Forward FLOPs: projections + scores + value mix."""
    proj = 2.0 * tokens * d * (n_heads * head_dim) \
        + 2.0 * 2.0 * kv_tokens * d * (n_kv * head_dim) \
        + 2.0 * tokens * (n_heads * head_dim) * d
    scores = 2.0 * 2.0 * tokens * kv_tokens * n_heads * head_dim
    return proj + scores
