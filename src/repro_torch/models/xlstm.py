"""xLSTM blocks (arXiv:2405.04517) as functional PyTorch: mLSTM (matrix
memory, parallelizable) and sLSTM (scalar memory, sequential scan).

The same computation as the JAX package's ``models/xlstm.py``.  mLSTM
training uses the stabilized parallel (quadratic) form — an attention-like
matmul with an input/forget-gate decay matrix D; decode uses the O(1)
recurrence

    C_t = f_t C_{t-1} + i_t v_t k_t^T ,  n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_t^T q_t|, exp(-m_t))

with log-space gate stabilization m_t.  sLSTM is inherently sequential
(recurrent hidden feedback): the reference runs it under ``lax.scan``, the
port as a Python loop over the time steps that autograd sees through.

Block wrappers follow the paper: mLSTM = pre-up-projection (×2) block;
sLSTM = post-up-projection block with a gated FFN (×4/3).  ``d_ff = 0`` in
the xlstm-1.3b config means exactly this: FFN capacity lives inside the
blocks.  The reference has no Pallas kernel here (plain ``jnp``), so
neither has the port.

On a process mesh the blocks run on DTensors.  The dense projections
and the conv (``layers.causal_conv1d``) are DTensor ops, the norms run on
each rank's batch rows (:func:`block_norm`), and what is independent
across batch rows and heads runs on each rank's own rows (the
``"batch"`` axes) and heads (``"heads"``) through
``sharding.on_rows_and_heads``, every placement stated: the per-head
projections, the mLSTM's parallel form and its final-state sums, and the
sLSTM's whole time loop, its weights and pre-activations redistributed
once a call, so that no collective falls inside the loop.  A decode
step moves its token, not the weights (:func:`_mm`,
:func:`_per_head_on_weight_shards`), and keeps the matrix memory ``C``
where the cache holds it (each rank's rows and slice of the key axis):
its update is elementwise there, and only the read-outs ``C·q`` and
``n·q``, partial sums over the key axis, are reduced.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from repro_torch.distributed.sharding import (gather_sequence, is_dtensor,
                                              on_rows_and_heads, on_shards,
                                              pinned, rows_and_heads,
                                              rows_and_heads_of,
                                              scatter_sequence, settled)
from .layers import (causal_conv1d, causal_conv1d_init, causal_conv1d_step,
                     dense_init, init_device, layernorm_init, norm_apply,
                     rmsnorm_init)


class XLSTMCfg(NamedTuple):
    d_model: int
    n_heads: int
    proj_factor_m: float = 2.0        # mLSTM pre-up-projection
    proj_factor_s: float = 4.0 / 3.0  # sLSTM FFN
    conv_width: int = 4

    @property
    def d_inner_m(self) -> int:
        return int(self.d_model * self.proj_factor_m)

    @property
    def head_dim_m(self) -> int:
        return self.d_inner_m // self.n_heads

    @property
    def head_dim_s(self) -> int:
        return self.d_model // self.n_heads


# ------------------------------------------------------------------ mLSTM --
class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, nh, hd, hd)
    n: torch.Tensor     # (B, nh, hd)
    m: torch.Tensor     # (B, nh), fp32
    conv: torch.Tensor  # (B, W-1, d_inner)


def mlstm_init(gen: torch.Generator, cfg: XLSTMCfg,
               dtype=torch.float32, *, device=None) -> Dict[str, Any]:
    d, di, nh = cfg.d_model, cfg.d_inner_m, cfg.n_heads
    hd = cfg.head_dim_m
    gs = split_generator(gen, 7)
    dev = init_device(gen, device)

    def blockdiag(g):
        # per-head (block-diagonal) projection, as in the official mLSTM
        return (torch.randn((nh, hd, hd), generator=g, device=dev,
                            dtype=torch.float32) / math.sqrt(hd)).to(dtype)

    return {
        "up": dense_init(gs[0], d, 2 * di, dtype, device=dev),  # (x_m, z)
        "conv": causal_conv1d_init(gs[1], di, cfg.conv_width, dtype,
                                   device=dev),
        "wq": blockdiag(gs[2]),
        "wk": blockdiag(gs[3]),
        "wv": blockdiag(gs[4]),
        "w_if": dense_init(gs[5], di, 2 * nh, dtype,     # i,f gate pre-acts
                           device=dev),
        "norm": rmsnorm_init(di, dtype, device=dev),
        "down": dense_init(gs[6], di, d, dtype, scale=1.0 / math.sqrt(di),
                           device=dev),
        # open forget gates; fp32 whatever the parameter dtype
        "f_bias": torch.full((nh,), 3.0, dtype=torch.float32, device=dev),
    }


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w; on DTensors with x's gradient delivered in x's placements
    (``sharding.pinned``), so that where two uses of x meet in the
    backward, no ``Partial`` gradient meets a sharded one.  A decode
    step's token (x of 2 dimensions: (B, d), where a sequence is (B, S,
    d)) is cut as w's input axis is and laid beside its output axis, the
    sums ``Partial`` where the input axis is cut: it moves the token's
    bytes, not the weight."""
    w = w.to(x.dtype)
    if not is_dtensor(x):
        return x @ w
    if x.dim() != 2:
        return scatter_sequence(pinned(gather_sequence(x)) @ w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    x_pl = [Shard(1) if pl == Shard(0) else Replicate()
            for pl in w.placements]
    out_pl = [Partial() if pl == Shard(0) else
              Shard(1) if pl == Shard(1) else Replicate()
              for pl in w.placements]
    return on_shards(torch.matmul, out_pl,
                     settled(x).redistribute(x.device_mesh, x_pl), w)


def block_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    """``layers.norm_apply``; on DTensors on each rank's batch rows with
    the normalized axis whole, as one device computes it (the norm's
    parameters replicated, their gradients ``Partial`` on the rows'
    axes).  DTensor would otherwise reduce over a sharded feature axis and
    leave ``Partial`` gradients inside the norm's backward."""
    if not is_dtensor(x):
        return norm_apply(kind, p, x)
    keys = sorted(p)
    axes = rows_and_heads_of(x.device_mesh, x.shape[0], None)
    return on_rows_and_heads(
        lambda h, *w: norm_apply(kind, dict(zip(keys, w)), h), axes,
        (x, *(p[k] for k in keys)),
        ((True, None),) + ((False, None),) * len(keys), ((True, None),))


def _by_rows_and_heads(fn, args, specs, out_specs):
    """``fn(*args)`` on each rank's batch rows and heads of DTensor
    arguments (``sharding.on_rows_and_heads``), the heads being the
    dimension ``specs[0]`` names of the first argument."""
    x = args[0]
    axes = rows_and_heads_of(x.device_mesh, x.shape[0], x.shape[specs[0][1]])
    return on_rows_and_heads(fn, axes, args, specs, out_specs)


def _mlstm_parallel(q, k, v, i_pre, f_pre):
    """q/k/v: (B,S,nh,hd); i_pre/f_pre: (B,S,nh).  Stabilized parallel form.
    On DTensors each rank runs it on its batch rows and heads: the causal
    mask, the cumulative log forget gates and the stabilizer are its own."""
    if is_dtensor(q):
        return _by_rows_and_heads(_mlstm_parallel, (q, k, v, i_pre, f_pre),
                                  ((True, 2),) * 5, ((True, 2),))
    B, S, nh, hd = q.shape
    logf = F.logsigmoid(f_pre.to(torch.float32))                # (B,S,nh)
    cum = torch.cumsum(logf, dim=1)
    # D_log[l,m] = cum_l - cum_m + i_m  (contribution of step m to step l)
    D_log = (cum[:, :, None, :] - cum[:, None, :, :]
             + i_pre.to(torch.float32)[:, None, :, :])          # (B,Sq,Sk,nh)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    D_log = torch.where(causal, D_log, D_log.new_full((), -math.inf))
    # amax splits the gradient among ties, as jnp.max does
    m_row = torch.amax(D_log, dim=2, keepdim=True)              # (B,S,1,nh)
    m_row = torch.maximum(m_row, m_row.new_full((), -1e30))
    D = torch.exp(D_log - m_row)
    scores = torch.einsum("blhd,bmhd->blmh", q, k) / math.sqrt(hd)
    w = scores.to(torch.float32) * D
    denom = torch.maximum(torch.abs(w.sum(dim=2)),
                          torch.exp(-m_row[:, :, 0, :]))        # (B,S,nh)
    y = torch.einsum("blmh,bmhd->blhd", w.to(v.dtype), v)
    return y / denom[..., None].to(v.dtype)


def _per_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The block-diagonal projection: x (B, [S,] nh, hd) by w (nh, hd, hd),
    head by head.  On DTensors each rank projects its rows and heads (a
    rank's gradient of w covers only its rows): the einsum's backward
    would otherwise flatten the heads with the sharded head_dim, which
    DTensor refuses in torch 2.11."""
    if is_dtensor(x) and x.dim() == 3:
        return _per_head_on_weight_shards(x, w)
    if is_dtensor(x):
        return _by_rows_and_heads(_per_head, (x, w),
                                  ((True, 2), (False, 0)), ((True, 2),))
    eq = "bsnd,nde->bsne" if x.dim() == 4 else "bnd,nde->bne"
    return torch.einsum(eq, x, w)


def _per_head_on_weight_shards(x: torch.Tensor, w: torch.Tensor
                               ) -> torch.Tensor:
    """:func:`_per_head` of one token, x (B, nh, hd), with w left where it
    lies: x is cut as w's input axis is (summed into ``Partial`` on that
    mesh axis) and laid beside w's heads and output axis.  A decode step
    moves a token's few bytes, not the layer's weights."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x_pl, out_pl = [], []
    for pl in w.placements:
        d = pl.dim if isinstance(pl, Shard) else None
        x_pl.append(Shard(d + 1) if d in (0, 1) else Replicate())
        out_pl.append(Partial() if d == 1 else Shard(1) if d == 0 else
                      Shard(2) if d == 2 else Replicate())
    x = settled(x).redistribute(x.device_mesh, x_pl)
    return on_shards(_per_head, out_pl, x, w)


def _mlstm_inputs(p, x: torch.Tensor, cfg: XLSTMCfg):
    """The up-projection, conv and gate pre-activations of a sequence:
    (xm, z, q, k, v, i_pre, f_pre)."""
    B, S, _ = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim_m
    up = _mm(x, p["up"]["w"])
    sharded = is_dtensor(up)
    if sharded:                       # xm's two uses give replicated grads
        up = settled(up)
    xm, z = up.chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(p["conv"], xm))
    xch = xc.reshape(B, S, nh, hd)
    q = _per_head(xch, p["wq"].to(x.dtype))
    k = _per_head(xch, p["wk"].to(x.dtype))
    v = _per_head(xm.reshape(B, S, nh, hd), p["wv"].to(x.dtype))
    i_pre, f_pre = _mm(xc, p["w_if"]["w"]).chunk(2, dim=-1)
    f_pre = f_pre + p["f_bias"][None, None, :].to(f_pre.dtype)
    return xm, pinned(z) if sharded else z, q, k, v, i_pre, f_pre


def _mlstm_out(p, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor):
    y = block_norm("rmsnorm", p["norm"], y) * F.silu(z)
    return _mm(y, p["down"]["w"])


def mlstm_block(p, x: torch.Tensor, cfg: XLSTMCfg) -> torch.Tensor:
    """Full-sequence mLSTM block body (the caller owns the residual)."""
    B, S, _ = x.shape
    _, z, q, k, v, i_pre, f_pre = _mlstm_inputs(p, x, cfg)
    y = _mlstm_parallel(q, k, v, i_pre, f_pre).reshape(B, S, cfg.d_inner_m)
    return _mlstm_out(p, y, z, x)


def mlstm_prefill(p, x: torch.Tensor, cfg: XLSTMCfg
                  ) -> Tuple[torch.Tensor, MLSTMState]:
    """Parallel-form forward that also emits the recurrent state after the
    last position (matches the decode recurrence: the running stabilizer
    m_t = max_{m≤t}(Σ_{j>m} log f_j + ĩ_m)).  The conv tail is the plain
    slice the reference takes, so a prompt shorter than ``conv_width - 1``
    leaves a short tail and the next decode step raises, as in JAX."""
    B, S, _ = x.shape
    xm, z, q, k, v, i_pre, f_pre = _mlstm_inputs(p, x, cfg)
    conv_tail = xm[:, S - (cfg.conv_width - 1):, :]
    y = _mlstm_parallel(q, k, v, i_pre, f_pre).reshape(B, S, cfg.d_inner_m)
    out = _mlstm_out(p, y, z, x)

    args = (k, v, i_pre, f_pre)
    if is_dtensor(k):                   # on each rank's rows and heads
        C, n, m_S = _by_rows_and_heads(_mlstm_final_state, args,
                                       ((True, 2),) * 4,
                                       ((True, 1),) * 3)
    else:
        C, n, m_S = _mlstm_final_state(*args)
    return out, MLSTMState(C=C, n=n, m=m_S, conv=conv_tail)


def _mlstm_final_state(k, v, i_pre, f_pre):
    """The recurrent state after the last position, (C, n, m): C̃_S =
    Σ_m exp(cum_S - cum_m + i_m - m_S) v_m k_m^T."""
    logf = F.logsigmoid(f_pre.to(torch.float32))
    cum = torch.cumsum(logf, dim=1)                             # (B,S,nh)
    w_log = cum[:, -1:, :] - cum + i_pre.to(torch.float32)      # (B,S,nh)
    m_S = torch.amax(w_log, dim=1)                              # (B,nh)
    w = torch.exp(w_log - m_S[:, None, :]).to(v.dtype)          # (B,S,nh)
    C = torch.einsum("bshv,bshk->bhvk", w[..., None] * v, k)
    n = torch.einsum("bsh,bshk->bhk", w, k)
    return C, n, m_S


def mlstm_state_init(cfg: XLSTMCfg, batch: int, dtype=torch.float32, *,
                     device) -> MLSTMState:
    nh, hd = cfg.n_heads, cfg.head_dim_m
    return MLSTMState(
        C=torch.zeros((batch, nh, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((batch, nh, hd), dtype=dtype, device=device),
        m=torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner_m),
                         dtype=dtype, device=device))


def mlstm_decode_step(p, x_t: torch.Tensor, state: MLSTMState,
                      cfg: XLSTMCfg) -> Tuple[torch.Tensor, MLSTMState]:
    """One token. x_t: (B, d_model) -> (y_t, new state); the new state is
    built out of place, ``state`` is left as it was."""
    B = x_t.shape[0]
    di, nh, hd = cfg.d_inner_m, cfg.n_heads, cfg.head_dim_m
    up = _mm(x_t, p["up"]["w"])
    xm, z = up.chunk(2, dim=-1)
    xc, new_conv = causal_conv1d_step(p["conv"], xm, state.conv)
    xc = F.silu(xc)
    xch = xc.reshape(B, nh, hd)
    q = _per_head(xch, p["wq"].to(x_t.dtype))
    k = _per_head(xch, p["wk"].to(x_t.dtype))
    v = _per_head(xm.reshape(B, nh, hd), p["wv"].to(x_t.dtype))
    i_pre, f_pre = _mm(xc, p["w_if"]["w"]).chunk(2, dim=-1)
    f_pre = (f_pre + p["f_bias"][None, :]).to(torch.float32)
    i_pre = i_pre.to(torch.float32)
    qs = q / math.sqrt(hd)
    args = (state.C, state.n, state.m, qs, k, v, i_pre, f_pre)
    if is_dtensor(state.C):
        C, n, m_new, num, nq = _matrix_step_on_shards(*args)
    else:
        C, n, m_new, num, nq = _matrix_step(*args)
    den = torch.maximum(torch.abs(nq), torch.exp(-m_new).to(x_t.dtype))
    y = (num / den[..., None]).reshape(B, di)
    return _mlstm_out(p, y, z, x_t), \
        MLSTMState(C=C, n=n, m=m_new, conv=new_conv)


def _matrix_step(C, n, m, qs, k, v, i_pre, f_pre):
    """One token's update of the matrix memory and its read-outs: (C, n,
    m, C·qs, n·qs), both products contracting the key axis."""
    logf = F.logsigmoid(f_pre)                                  # (B,nh)
    m_new = torch.maximum(logf + m, i_pre)
    fs = torch.exp(logf + m - m_new).to(qs.dtype)[..., None]
    is_ = torch.exp(i_pre - m_new).to(qs.dtype)[..., None]
    C = fs[..., None] * C + is_[..., None] * v[..., :, None] * k[..., None, :]
    n = fs * n + is_ * k
    num = torch.einsum("bhvk,bhk->bhv", C, qs)
    return C, n, m_new, num, torch.einsum("bhk,bhk->bh", n, qs)


def _matrix_step_on_shards(C, n, m, qs, k, v, i_pre, f_pre):
    """:func:`_matrix_step` on DTensors, with ``C`` (B, nh, hd, hd) and
    ``n`` left where the cache holds them: each rank's batch rows, and on
    the axis that splits ``C``'s key axis its slice of it (``qs`` and
    ``k`` are cut alike).  The update is elementwise there; the read-outs
    come out ``Partial`` on that axis and only they, (B, nh, hd) and (B,
    nh), are reduced.  The stabilizer ``m`` (B, nh) is gathered whole on
    that axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    axes = rows_and_heads(C, head_dim=3)         # "heads": the key axis

    def placed(key_dim, key=Replicate()):
        return [Shard(0) if a == "rows" else
                (Shard(key_dim) if key_dim is not None else key)
                if a == "heads" else Replicate() for a in axes]
    mesh = C.device_mesh
    dims = (3, 2, None, 2, 2, None, None, None)
    args = [a.redistribute(mesh, placed(d)) for a, d in zip(
        (C, n, m, qs, k, v, i_pre, f_pre), dims)]
    C, n, m_new, num, nq = on_shards(
        _matrix_step, (placed(3), placed(2), placed(None),
                       placed(None, Partial()), placed(None, Partial())),
        *args)
    return (C, n, m_new, num.redistribute(mesh, placed(None)),
            nq.redistribute(mesh, placed(None)))


# ------------------------------------------------------------------ sLSTM --
class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, nh, hd)
    n: torch.Tensor     # (B, nh, hd)
    h: torch.Tensor     # (B, nh, hd)
    m: torch.Tensor     # (B, nh, hd), fp32


def _slstm_ffn_width(cfg: XLSTMCfg) -> int:
    """×4/3 gated FFN, rounded up to a multiple of 64 (the official xLSTM
    does the same)."""
    raw = int(cfg.proj_factor_s * cfg.d_model)
    return -(-raw // 64) * 64


def slstm_init(gen: torch.Generator, cfg: XLSTMCfg,
               dtype=torch.float32, *, device=None) -> Dict[str, Any]:
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_s
    d_ff = _slstm_ffn_width(cfg)
    gs = split_generator(gen, 5)
    dev = init_device(gen, device)
    s = 1.0 / math.sqrt(hd)
    return {
        # input projections for gates z,i,f,o : (d, 4*d)
        "w_in": dense_init(gs[0], d, 4 * d, dtype, device=dev),
        # recurrent per-head block-diagonal: (4, nh, hd, hd)
        "r": (torch.randn((4, nh, hd, hd), generator=gs[1], device=dev,
                          dtype=torch.float32) * s).to(dtype),
        "b": torch.zeros((4, d), dtype=dtype, device=dev),
        "gn": layernorm_init(d, dtype, device=dev),
        "ffn_gate": dense_init(gs[2], d, d_ff, dtype, device=dev),
        "ffn_up": dense_init(gs[3], d, d_ff, dtype, device=dev),
        "ffn_down": dense_init(gs[4], d_ff, d, dtype,
                               scale=1.0 / math.sqrt(d_ff), device=dev),
        "f_bias": torch.full((nh, hd), 3.0, dtype=torch.float32, device=dev),
    }


def _recurrent_weights(r: torch.Tensor) -> torch.Tensor:
    """(4, nh, hd, hd) -> (nh, hd, 4*hd): the per-head recurrent matrices
    side by side, so a step's four gate products are one batched matmul.
    ``slstm_seq`` packs them once a call, not once a step."""
    g, nh, hd, e = r.shape
    return r.permute(1, 2, 0, 3).reshape(nh, hd, g * e)


def _slstm_cell(x_proj_t: torch.Tensor, state: SLSTMState,
                r_packed: torch.Tensor, b: torch.Tensor,
                f_bias: torch.Tensor) -> Tuple[torch.Tensor, SLSTMState]:
    """One sLSTM step.  x_proj_t: (B, 4, nh, hd) pre-activations from the
    input; ``r_packed``: ``_recurrent_weights(r)``; ``b`` (4, nh, hd) in
    ``x_proj_t``'s dtype; ``f_bias`` (nh, hd)."""
    B, _, nh, hd = x_proj_t.shape
    # rec[b, g, h, e] = Σ_d h[b, h, d] r[g, h, d, e]
    rec = torch.bmm(state.h.transpose(0, 1), r_packed.to(state.h.dtype))
    rec = rec.reshape(nh, B, 4, hd).permute(1, 2, 0, 3)
    pre = x_proj_t + rec + b[None]
    z_pre, i_pre, f_pre, o_pre = pre.unbind(1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logi = i_pre.to(torch.float32)
    logf = F.logsigmoid(f_pre.to(torch.float32) + f_bias[None])
    m_new = torch.maximum(logf + state.m, logi)
    i_s = torch.exp(logi - m_new).to(z.dtype)
    f_s = torch.exp(logf + state.m - m_new).to(z.dtype)
    c = f_s * state.c + i_s * z
    n = f_s * state.n + i_s
    # maximum, not clamp: n starts at exactly 1, and at that tie maximum
    # splits the gradient in halves, as jnp.maximum does
    h = o * c / torch.maximum(torch.abs(n), n.new_full((), 1.0))
    return h, SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_seq(p, x: torch.Tensor, cfg: XLSTMCfg,
              state: Optional[SLSTMState] = None
              ) -> Tuple[torch.Tensor, SLSTMState]:
    """Sequential sLSTM over (B, S, d); returns the head outputs (B, S, d)
    and the state after the last step.  On DTensors the whole time loop
    runs on each rank's batch rows and heads: the pre-activations, ``r``,
    ``b`` and ``f_bias`` are redistributed once a call, and no collective
    falls inside the loop; the state comes out on rows and heads."""
    B, S, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim_s
    xp = _mm(x, p["w_in"]["w"]).reshape(B, S, 4, nh, hd)
    hs, state = _slstm_run(p, xp, state)
    return hs.reshape(B, S, d), state


def _slstm_run(p, xp: torch.Tensor, state: Optional[SLSTMState]
               ) -> Tuple[torch.Tensor, SLSTMState]:
    """The cell over xp (B, S, 4, nh, hd): (h (B, S, nh, hd), the last
    state), on each rank's rows and heads for DTensors.  A rank's gradient
    of ``r``, ``b`` and ``f_bias`` covers only its rows: ``Partial`` on the
    rows' axes."""
    b = p["b"].reshape(4, *xp.shape[-2:])
    args = (xp, p["r"], b, p["f_bias"]) + tuple(state or (None,) * 4)
    if is_dtensor(xp):
        hs, *st = _by_rows_and_heads(
            _slstm_loop, args, ((True, 3), (False, 1), (False, 1),
                                (False, 0)) + ((True, 1),) * 4,
            ((True, 2),) + ((True, 1),) * 4)
    else:
        hs, *st = _slstm_loop(*args)
    return hs, SLSTMState(*st)


def _slstm_loop(xp, r, b, f_bias, c, n, h, m):
    """The time loop on plain tensors; a state of ``None`` starts at zero
    at xp's (local) shape.  Returns (h (B, S, nh, hd), c, n, h, m)."""
    B, _, _, nh, hd = xp.shape
    state = SLSTMState(c, n, h, m) if c is not None else \
        _slstm_zero_state(B, nh, hd, xp.dtype, xp.device)
    r_packed = _recurrent_weights(r)
    b = b.to(xp.dtype)
    hs = []
    for xt in torch.unbind(xp, 1):
        h, state = _slstm_cell(xt, state, r_packed, b, f_bias)
        hs.append(h)
    return (torch.stack(hs, 1),) + tuple(state)


def slstm_state_init(cfg: XLSTMCfg, batch: int, dtype=torch.float32, *,
                     device) -> SLSTMState:
    return _slstm_zero_state(batch, cfg.n_heads, cfg.head_dim_s, dtype,
                             device)


def _slstm_zero_state(batch, nh, hd, dtype, device) -> SLSTMState:
    def z():
        return torch.zeros((batch, nh, hd), dtype=dtype, device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, nh, hd), -1e30,
                                   dtype=torch.float32, device=device))


def slstm_block_ffn(p, y: torch.Tensor) -> torch.Tensor:
    """Post-cell part of the sLSTM block: group-norm + gated FFN (GELU,
    tanh approximation: ``jax.nn.gelu``'s default)."""
    y = block_norm("layernorm", p["gn"], y)
    h = F.gelu(_mm(y, p["ffn_gate"]["w"]), approximate="tanh") \
        * _mm(y, p["ffn_up"]["w"])
    return _mm(h, p["ffn_down"]["w"])


def slstm_block(p, x: torch.Tensor, cfg: XLSTMCfg) -> torch.Tensor:
    """sLSTM block body: cell scan + group-norm + gated FFN."""
    y, _ = slstm_seq(p, x, cfg)
    return slstm_block_ffn(p, y)


def slstm_decode_step(p, x_t: torch.Tensor, state: SLSTMState,
                      cfg: XLSTMCfg) -> Tuple[torch.Tensor, SLSTMState]:
    """One token through the cell (on each rank's rows and heads for
    DTensors, as :func:`slstm_seq`) and the FFN."""
    B, d = x_t.shape
    nh, hd = cfg.n_heads, cfg.head_dim_s
    xp = _mm(x_t, p["w_in"]["w"]).reshape(B, 1, 4, nh, hd)
    h, state = _slstm_run(p, xp, state)
    return slstm_block_ffn(p, h.reshape(B, d)), state


def mlstm_flops(tokens: int, seq: int, cfg: XLSTMCfg) -> float:
    d, di, nh, hd = cfg.d_model, cfg.d_inner_m, cfg.n_heads, cfg.head_dim_m
    proj = 2.0 * tokens * d * 2 * di \
        + 2.0 * tokens * (3 * nh * hd * hd + di * 2 * nh) \
        + 2.0 * tokens * di * d
    quad = 2.0 * 2.0 * tokens * seq * nh * hd
    return proj + quad


def slstm_flops(tokens: int, cfg: XLSTMCfg) -> float:
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_s
    d_ff = _slstm_ffn_width(cfg)
    cell = 2.0 * tokens * d * 4 * d + 2.0 * tokens * 4 * nh * hd * hd
    ffn = 2.0 * tokens * d * d_ff * 3
    return cell + ffn
