"""Grouped-query attention, training path.

GQA with arbitrary (n_heads, n_kv_heads) — MHA when equal — causal or
bidirectional masking, an optional sliding window, and RoPE where the
config asks for it.  The cached prefill/decode paths of the JAX package
come with the serving slice.

Layout conventions (the JAX package's): activations (B, S, d); q/k/v
(B, S, H, hd).  Scores and softmax run in fp32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.opgraph import split_generator
from .layers import apply_rope, dense, dense_init

NEG_INF = -1e30


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
              q_offset: int = 0, device="cpu") -> Optional[torch.Tensor]:
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


def attn_flops(tokens: int, kv_tokens: int, d: int, n_heads: int, n_kv: int,
               head_dim: int) -> float:
    """Forward FLOPs: projections + scores + value mix."""
    proj = 2.0 * tokens * d * (n_heads * head_dim) \
        + 2.0 * 2.0 * kv_tokens * d * (n_kv * head_dim) \
        + 2.0 * tokens * (n_heads * head_dim) * d
    scores = 2.0 * 2.0 * tokens * kv_tokens * n_heads * head_dim
    return proj + scores
