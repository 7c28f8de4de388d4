"""Mamba2 (SSD) blocks — the chunked matmul formulation, as functional
PyTorch.

The same recurrence as the JAX package's ``models/ssm.py``,

    h_t = a_t · h_{t-1} + Δt_t · B_t ⊗ x_t          a_t = exp(A·Δt_t)
    y_t = C_t · h_t + D · x_t

in *chunked* form: the sequence splits into chunks of length Lc; the
intra-chunk terms are dense einsums, the inter-chunk terms a short loop
over per-chunk states (S/Lc steps), with the state in fp32.  ngroups=1
(B/C shared across heads), a scalar A per head — the Mamba2 defaults.
The reference has no Pallas kernel here (plain ``jnp`` einsums and a
``lax.scan``), so neither has the port.  The SSD makes the reference's
five sharding ``constrain`` calls (x, Δt and log A, then the segment sums
and the decay, with the heads on ``model``): the identity on one device,
a redistribution of DTensors on a process mesh.  The segment sums, and
everything from the decay on, are independent across batch rows and
heads, so on DTensors each rank runs them on its own rows and heads
(``sharding.on_shards``, every placement stated): the causal mask, the
recurrence and its zero state are the rank's own, with no collective.
The decode step's state update runs the same way.

Decode is the O(1)-state recurrence (:func:`mamba_decode_step`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              on_rows_and_heads, on_shards,
                                              rows_and_heads)
from .layers import (causal_conv1d, causal_conv1d_init, causal_conv1d_step,
                     dense, dense_init, init_device, rmsnorm, rmsnorm_init)


class MambaCfg(NamedTuple):
    d_model: int
    d_inner: int          # expand * d_model
    n_heads: int          # d_inner // head_dim
    head_dim: int
    d_state: int          # ssm_state (assigned: 64)
    conv_width: int = 4
    chunk: int = 128


class MambaState(NamedTuple):
    """Decode cache for one layer."""
    h: torch.Tensor       # (B, nh, d_state, head_dim)
    conv: torch.Tensor    # (B, conv_width-1, d_inner + 2*d_state)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) at every x; ``F.softplus``
    turns linear above its threshold of 20."""
    return torch.log1p(torch.exp(-x.abs())) + torch.relu(x)


def mamba_init(gen: torch.Generator, cfg: MambaCfg,
               dtype=torch.float32, *, device=None) -> Dict[str, Any]:
    d, di, nh, ds = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_state
    g1, g2, g3, g4 = split_generator(gen, 4)
    dev = init_device(gen, device)
    d_in_proj = 2 * di + 2 * ds + nh          # z, x, B, C, dt
    conv_ch = di + 2 * ds
    # dt bias: softplus^-1 of dt in [1e-3, 1e-1] (mamba default init)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nh,), generator=g3, device=dev,
                   dtype=torch.float32) * (hi - lo) + lo
    dt0 = torch.exp(u)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "in_proj": dense_init(g1, d, d_in_proj, dtype, device=dev),
        "conv": causal_conv1d_init(g2, conv_ch, cfg.conv_width, dtype,
                                   device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev,
                                          dtype=torch.float32)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm": rmsnorm_init(di, dtype, device=dev),
        "out_proj": dense_init(g4, di, d, dtype, scale=1.0 / math.sqrt(di),
                               device=dev),
    }


def _split_proj(cfg: MambaCfg, zxbcdt: torch.Tensor):
    di, ds = cfg.d_inner, cfg.d_state
    return torch.split(zxbcdt, [di, di, ds, ds, cfg.n_heads], dim=-1)


def _segsum_chunk(log_a: torch.Tensor) -> torch.Tensor:
    """log_a: (..., Lc).  Returns (..., Lc, Lc) with [l, m] = Σ_{j=m+1..l},
    -inf above the diagonal (strictly causal cumulative decay).  On a
    DTensor each rank sums its own rows (the last axis whole): DTensor in
    torch 2.11 has no sharding strategy for the flip in cumsum's
    backward."""
    if is_dtensor(log_a):               # placed with the last axis whole
        return on_shards(_segsum_chunk, list(log_a.placements), log_a)
    L = log_a.shape[-1]
    s = torch.cumsum(log_a, dim=-1)
    diff = s[..., :, None] - s[..., None, :]      # s_l - s_m
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, diff.new_full((), -math.inf))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Structured state-space duality, chunked.

    x: (B,S,nh,hd); dt: (B,S,nh) (post-softplus); A: (nh,) negative;
    Bm, Cm: (B,S,ds); D: (nh,).  Returns (y (B,S,nh,hd), h_final
    (B,nh,ds,hd) in fp32).  ``S`` must be a multiple of ``chunk``: it raises
    otherwise, as the reference does, and pads nothing."""
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    if S % chunk != 0:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, nh, hd)
    dtc = dt.reshape(Bsz, nc, chunk, nh)
    Bc = Bm.reshape(Bsz, nc, chunk, ds)
    Cc = Cm.reshape(Bsz, nc, chunk, ds)

    # the SSM heads on the model axis, as in the reference: the
    # (B,nc,nh,Lc,Lc) decay is the largest tensor of the chunked SSD
    xc = constrain(xc, ("batch", None, None, "model", None))
    dtc = constrain(dtc, ("batch", None, None, "model"))
    log_a = A[None, None, None, :] * dtc                # (B,nc,Lc,nh) ≤ 0
    log_a = constrain(log_a, ("batch", None, None, "model"))
    seg = _segsum_chunk(log_a.movedim(-1, -2))          # (B,nc,nh,Lc,Lc)
    seg = constrain(seg, ("batch", None, "model", None, None))
    decay = torch.exp(seg)
    decay = constrain(decay, ("batch", None, "model", None, None))

    args = (xc, dtc, log_a, decay, Bc, Cc, x, D, h0)
    if is_dtensor(xc):
        # what follows is independent across batch rows and heads: each
        # rank computes its share as one device would
        axes = rows_and_heads(xc, head_dim=3)
        return on_rows_and_heads(
            _ssd_from_decay, axes, args,
            ((True, 3), (True, 3), (True, 3), (True, 2), (True, None),
             (True, None), (True, 2), (False, 0), (True, 1)),
            ((True, 2), (True, 1)))
    return _ssd_from_decay(*args)


def _ssd_from_decay(xc, dtc, log_a, decay, Bc, Cc, x, D, h0):
    """The chunked SSD from the decay on: the intra-chunk products, the
    per-chunk states, their recurrence and the inter-chunk term, and the
    D skip.  The shapes come from the tensors, so it runs on any rank's
    batch rows and heads."""
    Bsz, S, nh, hd = x.shape
    nc = xc.shape[1]
    # intra-chunk: y[l] += Σ_{m≤l} (C_l·B_m) exp(s_l-s_m) dt_m x_m, the
    # multi-operand product decomposed in the reference's order
    CB = torch.einsum("bcls,bcms->bclm", Cc, Bc)        # (B,nc,Lc,Lc)
    W = CB[:, :, None] * decay                          # (B,nc,nh,Lc,Lc)
    Wdt = W * dtc.movedim(-1, -2)[:, :, :, None, :].to(W.dtype)
    Y_intra = torch.einsum("bchlm,bcmhp->bclhp", Wdt, xc.to(W.dtype))

    # per-chunk outgoing state: H_c = Σ_m exp(s_last-s_m) dt_m B_m ⊗ x_m
    s_cum = torch.cumsum(log_a, dim=2)                  # (B,nc,Lc,nh)
    w_out = torch.exp(s_cum[:, :, -1:, :] - s_cum) * dtc
    wx = w_out[..., None] * xc.to(w_out.dtype)          # (B,nc,Lc,nh,hd)
    H = torch.einsum("bclhp,bcls->bchsp", wx,
                     Bc.to(wx.dtype))                   # (B,nc,nh,ds,hd)
    chunk_decay = torch.exp(s_cum[:, :, -1, :])         # (B,nc,nh)

    # inter-chunk recurrence h_c = decay_c · h_{c-1} + H_c, in fp32
    h = (h0.to(torch.float32) if h0 is not None
         else torch.zeros_like(H[:, 0], dtype=torch.float32))
    h_starts = []                                       # state at chunk start
    for c in range(nc):
        h_starts.append(h)
        h = chunk_decay[:, c, :, None, None] * h + H[:, c].to(torch.float32)
    h_starts = torch.stack(h_starts, dim=1)             # (B,nc,nh,ds,hd)

    # inter-chunk contribution: y[l] += exp(s_l) C_l · h_start
    Ch = torch.einsum("bcls,bchsp->bclhp", Cc.to(torch.float32), h_starts)
    Y_inter = Ch * torch.exp(s_cum)[..., None]
    y = (Y_intra.to(torch.float32) + Y_inter).reshape(Bsz, S, nh, hd)
    y = y.to(x.dtype) + x * D[None, None, :, None].to(x.dtype)
    return y, h


def _ssm_inputs(p, cfg: MambaCfg, conv_out: torch.Tensor, dt: torch.Tensor):
    xi, Bc, Cc = torch.split(
        F.silu(conv_out), [cfg.d_inner, cfg.d_state, cfg.d_state], dim=-1)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    return xi, Bc, Cc, dt


def _out(p, y: torch.Tensor, z: torch.Tensor):
    y = rmsnorm(p["norm"], y) * F.silu(z)
    return dense(p["out_proj"], y)


def mamba_prefill(p, x: torch.Tensor, cfg: MambaCfg
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence forward that also emits the decode state (final SSM
    state + conv tail), so decoding can continue after the prompt."""
    B, S, _ = x.shape
    zxbcdt = dense(p["in_proj"], x)
    z, xi, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_tail = conv_in[:, S - (cfg.conv_width - 1):, :]
    xi, Bc, Cc, dt = _ssm_inputs(p, cfg, causal_conv1d(p["conv"], conv_in),
                                 dt)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, cfg.n_heads, cfg.head_dim)
    y, h_last = ssd_chunked(xh, dt, A, Bc, Cc, p["D"], cfg.chunk)
    y = _out(p, y.reshape(B, S, cfg.d_inner), z)
    return y, MambaState(h=h_last.to(x.dtype), conv=conv_tail)


def mamba_train(p, x: torch.Tensor, cfg: MambaCfg) -> torch.Tensor:
    """Full-sequence Mamba2 block body (no residual/out-norm — the caller
    owns the residual stream)."""
    return mamba_prefill(p, x, cfg)[0]


def mamba_state_init(cfg: MambaCfg, batch: int, dtype=torch.float32, *,
                     device) -> MambaState:
    return MambaState(
        h=torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                      dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1,
                          cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                         device=device))


def mamba_decode_step(p, x_t: torch.Tensor, state: MambaState,
                      cfg: MambaCfg) -> Tuple[torch.Tensor, MambaState]:
    """One token. x_t: (B, d_model) -> (y_t (B, d_model), new state); the
    new state is built out of place, ``state`` is left as it was."""
    B = x_t.shape[0]
    zxbcdt = x_t @ p["in_proj"]["w"].to(x_t.dtype)
    z, xi, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_out, new_window = causal_conv1d_step(p["conv"], conv_in, state.conv)
    xi, Bc, Cc, dt = _ssm_inputs(p, cfg, conv_out, dt)          # dt (B,nh)
    xh = xi.reshape(B, cfg.n_heads, cfg.head_dim)
    args = (dt, Bc, Cc, xh, state.h, p["A_log"], p["D"])
    if is_dtensor(state.h):            # each rank on its rows and heads
        y, h = on_rows_and_heads(
            _state_update, rows_and_heads(state.h, head_dim=1), args,
            ((True, 1), (True, None), (True, None), (True, 1), (True, 1),
             (False, 0), (False, 0)), ((True, 1), (True, 1)))
    else:
        y, h = _state_update(*args)
    y = _out(p, y.reshape(B, cfg.d_inner), z)
    return y, MambaState(h=h, conv=new_window)


def _state_update(dt, Bc, Cc, xh, h, A_log, D):
    """One token's recurrence, h = a·h + Δt · B ⊗ x and y = C · h + D · x:
    (y (B,nh,hd), the new h)."""
    a = torch.exp(-torch.exp(A_log)[None, :] * dt)             # (B,nh)
    upd = torch.einsum("bh,bs,bhp->bhsp", dt.to(xh.dtype), Bc, xh)
    h = a[:, :, None, None].to(xh.dtype) * h + upd
    y = torch.einsum("bs,bhsp->bhp", Cc, h) \
        + xh * D[None, :, None].to(xh.dtype)
    return y, h


def ssd_reference(x, dt, A, Bm, Cm, D):
    """O(S) sequential oracle for tests: the literal recurrence."""
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    h = torch.zeros((Bsz, nh, ds, hd), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(A[None, :] * dt[:, t]).to(torch.float32)  # (B,nh)
        upd = torch.einsum("bh,bs,bhp->bhsp", dt[:, t], Bm[:, t], x[:, t])
        h = a[:, :, None, None] * h + upd
        ys.append(torch.einsum("bs,bhsp->bhp", Cm[:, t], h)
                  + x[:, t] * D[None, :, None])
    return torch.stack(ys, dim=1)


def mamba_flops(tokens: int, cfg: MambaCfg) -> float:
    """Forward FLOPs: projections + conv + SSD (intra-chunk matmul terms)."""
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    proj = 2.0 * tokens * d * (2 * di + 2 * ds + nh) + 2.0 * tokens * di * d
    conv = 2.0 * tokens * (di + 2 * ds) * cfg.conv_width
    Lc = cfg.chunk
    ssd = (2.0 * tokens * Lc * ds                    # CB^T
           + 2.0 * tokens * Lc * nh * cfg.head_dim   # (CB·decay·dt) @ x
           + 4.0 * tokens * ds * nh * cfg.head_dim)  # state in/out
    return proj + conv + ssd
