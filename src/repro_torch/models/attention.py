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

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from repro_torch.distributed.sharding import constrain, is_dtensor, on_shards
from repro_torch.obs.trace import span
from .layers import apply_rope, dense, dense_init, init_device

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, H_kv, hd)
    v: torch.Tensor     # (B, S_max, H_kv, hd)


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, dtype=torch.float32,
              qkv_bias: bool = False, *, device=None) -> Dict[str, Any]:
    gq, gk, gv, go = split_generator(gen, 4)
    dev = init_device(gen, device)
    p = {"wq": dense_init(gq, d, n_heads * head_dim, dtype, device=dev),
         "wk": dense_init(gk, d, n_kv * head_dim, dtype, device=dev),
         "wv": dense_init(gv, d, n_kv * head_dim, dtype, device=dev),
         "wo": dense_init(go, n_heads * head_dim, d, dtype,
                          scale=1.0 / math.sqrt(n_heads * head_dim),
                          device=dev)}
    if qkv_bias:
        p["bq"] = torch.zeros(n_heads * head_dim, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(n_kv * head_dim, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(n_kv * head_dim, dtype=dtype, device=dev)
    return p


def _project_flat(p, x_q, x_kv):
    """q, k, v with the heads still flat: (B, S, H·hd)."""
    q = dense({"w": p["wq"]["w"]}, x_q)
    k = dense({"w": p["wk"]["w"]}, x_kv)
    v = dense({"w": p["wv"]["w"]}, x_kv)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _project_qkv(p, x_q, x_kv, n_heads, n_kv, head_dim):
    B, Sq = x_q.shape[:2]
    Skv = x_kv.shape[1]
    q, k, v = _project_flat(p, x_q, x_kv)
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
    cross-attention (both sides get positions of their own sequence).

    On DTensors (a process mesh) the projections run sharded and the
    attention itself runs on each rank's batch rows and heads
    (:func:`_attend_sharded`), as GSPMD partitions it."""
    src = x if x_kv is None else x_kv
    q, k, v = _project_flat(p, x, src)
    core = functools.partial(
        _attend, head_dim=head_dim, causal=causal and x_kv is None,
        window=window, rope_fraction=rope_fraction, rope_theta=rope_theta)
    with span("attn"):
        if is_dtensor(q):
            out = _attend_sharded(core, q, k, v, n_kv)
        else:
            out = core(q, k, v)
    return dense({"w": p["wo"]["w"]}, out)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            head_dim: int, causal: bool, window: Optional[int],
            rope_fraction: float, rope_theta: float) -> torch.Tensor:
    """Attention of flat q (B, Sq, H·hd) over flat k, v (B, Skv, Hkv·hd):
    heads split, RoPE, mask, :func:`sdpa`, heads merged.  The head counts
    come from the shapes, so it runs on any rank's share of the heads."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    q = q.reshape(B, Sq, -1, head_dim)
    k = k.reshape(B, Skv, -1, head_dim)
    v = v.reshape(B, Skv, -1, head_dim)
    if rope_fraction > 0:
        qpos = torch.arange(Sq, device=q.device)[None]
        kpos = torch.arange(Skv, device=q.device)[None]
        q = apply_rope(q, qpos, rope_fraction, rope_theta)
        k = apply_rope(k, kpos, rope_fraction, rope_theta)
    mask = make_mask(Sq, Skv, causal, window, device=q.device)
    out = sdpa(q, k, v, mask)
    return out.reshape(B, Sq, -1)


def _attend_sharded(core, q, k, v, n_kv: int, n_out: int = 1):
    """``core`` on DTensor q, k, v, each rank on its share: the rows of the
    batch where the mesh shards it, and the heads on the ``model`` axis
    where it divides the KV heads (GQA groups stay whole on a rank);
    otherwise the heads are gathered on that axis first (gpt2-xl's 25
    heads over 2).  The attention is independent across batch rows and
    heads, so each rank computes its share exactly as one device would.
    ``core`` returns ``n_out`` tensors whose dimension 2 is the heads (flat
    or not), all placed alike."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    target = []
    for name, size, pl in zip(mesh.mesh_dim_names, mesh.shape, q.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            target.append(pl)
        elif name == "model" and n_kv % size == 0:
            target.append(Shard(2))
        else:
            target.append(Replicate())
    target = tuple(target)
    q, k, v = (t.redistribute(mesh, target) for t in (q, k, v))
    out_pl = list(target) if n_out == 1 else (list(target),) * n_out
    return on_shards(core, out_pl, q, k, v)


def attn_prefill(p, x: torch.Tensor, *, n_heads: int, n_kv: int,
                 head_dim: int, cache_len: int, window: Optional[int] = None,
                 rope_fraction: float = 1.0, rope_theta: float = 10_000.0
                 ) -> Tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt, emitting a KV cache of cache_len
    (>= S; right-padded with zeros).  On DTensors each rank attends over
    its batch rows and heads (:func:`_attend_sharded`) and returns its
    share of the cache, placed as the heads are; the step places the cache
    where the decode step takes it."""
    q, k, v = _project_flat(p, x, x)
    core = functools.partial(_prefill_core, head_dim=head_dim,
                             cache_len=cache_len, window=window,
                             rope_fraction=rope_fraction,
                             rope_theta=rope_theta)
    if is_dtensor(q):
        out, ck, cv = _attend_sharded(core, q, k, v, n_kv, n_out=3)
    else:
        out, ck, cv = core(q, k, v)
    return dense({"w": p["wo"]["w"]}, out), KVCache(k=ck, v=cv)


def _prefill_core(q, k, v, *, head_dim: int, cache_len: int,
                  window: Optional[int], rope_fraction: float,
                  rope_theta: float):
    """Flat q, k, v (B, S, heads·hd) of any share of the heads -> the
    attention output (B, S, heads·hd) and the KV cache (B, cache_len,
    kv heads, hd)."""
    B, S = q.shape[:2]
    q = q.reshape(B, S, -1, head_dim)
    k = k.reshape(B, S, -1, head_dim)
    v = v.reshape(B, S, -1, head_dim)
    if rope_fraction > 0:
        pos = torch.arange(S, device=q.device)[None]
        q = apply_rope(q, pos, rope_fraction, rope_theta)
        k = apply_rope(k, pos, rope_fraction, rope_theta)
    mask = make_mask(S, S, True, window, device=q.device)
    out = sdpa(q, k, v, mask)
    pad = (0, 0, 0, 0, 0, cache_len - S)     # the sequence axis, at the end
    return out.reshape(B, S, -1), F.pad(k, pad), F.pad(v, pad)


def attn_decode(p, x: torch.Tensor, cache: KVCache, pos: torch.Tensor, *,
                n_heads: int, n_kv: int, head_dim: int,
                window: Optional[int] = None,
                rope_fraction: float = 1.0, rope_theta: float = 10_000.0
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B, 1, d); ``pos`` a 0-d int32 tensor on the
    cache's device — the index of this token; the cache holds positions
    [0, pos).  The mask and the write position come from ``pos`` on the
    device, so a step reads nothing back to the host.  On DTensors see
    :func:`_decode_sharded`."""
    if is_dtensor(x):
        return _decode_sharded(p, x, cache, pos, head_dim=head_dim,
                               window=window, rope_fraction=rope_fraction,
                               rope_theta=rope_theta)
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv, head_dim)
    if rope_fraction > 0:
        pvec = pos.reshape(1, 1)
        q = apply_rope(q, pvec, rope_fraction, rope_theta)
        k = apply_rope(k, pvec, rope_fraction, rope_theta)
    new_k = _write(cache.k, k, pos)
    new_v = _write(cache.v, v, pos)
    mask = _decode_mask(new_k.shape[1], pos, window)
    out = sdpa(q, new_k.to(q.dtype), new_v.to(q.dtype), mask)
    y = dense({"w": p["wo"]["w"]}, out.reshape(B, 1, n_heads * head_dim))
    return y, KVCache(k=new_k, v=new_v)


def _write(cache: torch.Tensor, t: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """A new cache: ``cache`` with ``t`` (B, 1, H, hd) at sequence ``pos``."""
    return cache.index_copy(1, pos.reshape(1).to(torch.int64),
                            t.to(cache.dtype))


def _decode_mask(s_max: int, pos: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """(1, 1, 1, S_max): the cache slots a token at ``pos`` attends to."""
    kpos = torch.arange(s_max, device=pos.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    return valid[None, None, None, :]


def _decode_sharded(p, x, cache: KVCache, pos, *, head_dim: int,
                    window: Optional[int], rope_fraction: float,
                    rope_theta: float) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode on DTensors, as GSPMD runs the JAX package's under
    its three ``constrain`` calls: q and the new cache sharded over batch
    and head_dim.  The new token's k, v are written into each rank's shard
    of the cache (the sequence is never sharded, so the write is local);
    the score contraction over the rank's slice of head_dim gives partial
    scores, summed over the axes that shard head_dim; the values mix on
    each rank's slice, and only the (B, 1, H, hd) output is gathered
    (:func:`attend_by_head_dim`).  The cache is never gathered."""
    mesh = x.device_mesh
    rows = rows_of(x)
    q, k, v = (t.redistribute(mesh, rows) for t in _project_flat(p, x, x))

    def heads(q, k, v, pos):
        q, k, v = (t.reshape(t.shape[0], 1, -1, head_dim) for t in (q, k, v))
        if rope_fraction > 0:
            pvec = pos.reshape(1, 1)
            q = apply_rope(q, pvec, rope_fraction, rope_theta)
            k = apply_rope(k, pvec, rope_fraction, rope_theta)
        return q, k, v
    q, k, v = on_shards(heads, (rows,) * 3, q, k, v, pos)
    c_pl = cache.k.placements
    new_k = on_shards(_write, c_pl, cache.k, k.redistribute(mesh, c_pl), pos)
    new_v = on_shards(_write, c_pl, cache.v, v.redistribute(mesh, c_pl), pos)
    spec = ("batch", None, None, "model")
    q, new_k, new_v = (constrain(t, spec) for t in (q, new_k, new_v))
    out = attend_by_head_dim(
        q, new_k, new_v, rows, head_dim=head_dim,
        mask=lambda s_max, pos: _decode_mask(s_max, pos, window).unsqueeze(2),
        mask_args=(pos,))
    return dense({"w": p["wo"]["w"]}, out), KVCache(k=new_k, v=new_v)


def rows_of(x) -> tuple:
    """The placements of DTensor ``x`` on its batch rows alone: each mesh
    axis that shards dimension 0 keeps it, the others replicate."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                 for pl in x.placements)


def attend_by_head_dim(q, k, v, rows, *, head_dim: int, mask=None,
                       mask_args=()):
    """Attention of DTensor q (B, Sq, H, hd) over k, v (B, Skv, Hkv, hd),
    k and v placed alike: the batch on some mesh axes, head_dim on others,
    the sequence whole.  q is cut to k's placements; each rank contracts
    its q against its slice of head_dim, the partial scores are summed
    over the axes that shard head_dim, the values mix on each rank's
    slice, and only the output is gathered, to ``rows``, with the heads
    flat: (B, Sq, H·hd).  k and v are never gathered.  ``mask(Skv,
    *mask_args)``, on each rank's local ``mask_args``, gives where the
    scores (B, Hkv, g, Sq, Skv) attend (True), or ``mask`` is ``None``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    kv_pl = tuple(k.placements)
    q = q.redistribute(mesh, kv_pl)
    scale = 1.0 / math.sqrt(head_dim)

    def scores(q, k):
        qg = q.reshape(q.shape[0], q.shape[1], k.shape[2], -1, q.shape[-1])
        return torch.einsum("bqkgd,bskd->bkgqs", qg,
                            k.to(q.dtype)).to(torch.float32) * scale
    by_hd = [isinstance(pl, Shard) and pl.dim == 3 for pl in kv_pl]
    s = on_shards(scores, [Partial() if h else pl
                           for h, pl in zip(by_hd, kv_pl)], q, k)
    s = s.redistribute(mesh, [Replicate() if h else pl
                              for h, pl in zip(by_hd, kv_pl)])

    def mix(s, v, *args):
        if mask is not None:
            s = torch.where(mask(v.shape[1], *args), s,
                            s.new_full((), NEG_INF))
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
        return out.reshape(out.shape[0], out.shape[1], -1, out.shape[-1])
    out = on_shards(mix, kv_pl, s, v, *mask_args).redistribute(mesh, rows)
    return on_shards(lambda o: o.reshape(o.shape[0], o.shape[1], -1), rows,
                     out)


def attn_flops(tokens: int, kv_tokens: int, d: int, n_heads: int, n_kv: int,
               head_dim: int) -> float:
    """Forward FLOPs: projections + scores + value mix."""
    proj = 2.0 * tokens * d * (n_heads * head_dim) \
        + 2.0 * 2.0 * kv_tokens * d * (n_kv * head_dim) \
        + 2.0 * tokens * (n_heads * head_dim) * d
    scores = 2.0 * 2.0 * tokens * kv_tokens * n_heads * head_dim
    return proj + scores
