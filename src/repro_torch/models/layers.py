"""Shared neural-net layers as functional PyTorch.

Every layer is an (init, apply) pair of plain functions; params are nested
dicts of tensors with the JAX package's key paths.  An init function draws
from the ``torch.Generator`` it is given and puts its tensors on that
generator's device, or on the device its ``device`` keyword names; one that
draws nothing (the norms) takes ``device`` as a required keyword.
``device="meta"`` with a CPU generator gives abstract parameters (shapes and
dtypes, no storage): ``torch.Generator(device="meta")`` does not exist.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator
from repro_torch.distributed.sharding import (gather_sequence, is_dtensor,
                                              on_shards, replicate_like,
                                              scatter_sequence)

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- norms --
def rmsnorm_init(d: int, dtype=torch.float32, *, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, *, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)


def norm_init(kind: str, d: int, dtype=torch.float32, *, device) -> Params:
    return (layernorm_init(d, dtype, device=device) if kind == "layernorm"
            else rmsnorm_init(d, dtype, device=device))


def norm_apply(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)


# ----------------------------------------------------------------- linears --
def init_device(gen: torch.Generator, device=None) -> torch.device:
    """Where an init function puts its tensors: ``device`` when given,
    else ``gen``'s device."""
    return gen.device if device is None else torch.device(device)


def _normal(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=init_device(gen, device),
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None, *,
               device=None) -> Params:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": (_normal(gen, (d_in, d_out), device) * s).to(dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w``; on DTensors with a sequence-sharded ``x`` gathered first
    and a partial-sum output scattered onto the sequence
    (``sharding.gather_sequence`` / ``scatter_sequence``)."""
    return scatter_sequence(gather_sequence(x) @ p["w"].to(x.dtype))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, *, device=None) -> Params:
    return {"table": (_normal(gen, (vocab, d), device) * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    t = p["table"]
    if dtype is not None:
        t = t.to(dtype)
    if is_dtensor(t):
        return _embed_sharded(t, replicate_like(tokens, t))
    return t[tokens.to(torch.int64)]


def _embed_sharded(table, tokens):
    """The lookup on a DTensor table, each rank on its tokens.  Where the
    table's rows and the tokens are sharded on one mesh axis, the tokens
    are gathered there instead of the table: each rank looks the tokens up
    in its rows (zeros elsewhere), the sum of those lookups (exact: one
    rank holds each row) is cut back as the tokens were, and the table's
    gradient there is each rank's own rows.  On the other axes the table's
    rows are gathered where they are sharded (and its columns where the
    tokens are sharded on the same mesh axis), the columns stay sharded
    elsewhere, and a rank's rows of the table's gradient cover only its
    tokens: ``Partial`` on the axes that shard the tokens, the sums
    meeting where the optimizer places it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import local_offset, settled
    mesh = table.device_mesh
    t_pl, tok_pl, look_pl, out_pl, grad_pl = [], [], [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        by_tokens = isinstance(kp, Shard)
        vocab = by_tokens and tp == Shard(0)
        cols = isinstance(tp, Shard) and tp.dim == 1 and not by_tokens
        t_pl.append(tp if vocab else Shard(1) if cols else Replicate())
        tok_pl.append(kp if by_tokens and not vocab else Replicate())
        out_pl.append(kp if by_tokens else
                      Shard(tokens.dim()) if cols else Replicate())
        look_pl.append(Partial() if vocab else out_pl[-1])
        grad_pl.append(tp if vocab else
                       Partial() if by_tokens else t_pl[-1])
    table = table.redistribute(mesh, t_pl)
    start, n = local_offset(table.shape, mesh, t_pl, 0)

    def look_up(t, k):
        k = k.to(torch.int64) - start
        mine = (k >= 0) & (k < n)
        rows = t[k.clamp(0, max(n - 1, 0))]
        return torch.where(mine[..., None], rows, rows.new_zeros(()))
    out = local_map(look_up, out_placements=look_pl,
                    in_placements=(t_pl, tok_pl),
                    in_grad_placements=(grad_pl, tok_pl),
                    device_mesh=mesh)(table, tokens.redistribute(mesh,
                                                                 tok_pl))
    return settled(out).redistribute(mesh, out_pl)


# -------------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, rope_fraction: float = 1.0,
               theta: float = 10_000.0) -> np.ndarray:
    """Inverse frequencies for the rotated slice of the head dim."""
    rot = int(head_dim * rope_fraction) // 2 * 2
    return 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               rope_fraction: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    rot = int(hd * rope_fraction) // 2 * 2
    inv = torch.as_tensor(rope_freqs(hd, rope_fraction, theta),
                          dtype=torch.float32, device=x.device)
    ang = positions.to(torch.float32)[..., None] * inv  # (..., S, rot/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- FFN --
def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str = "silu",
             dtype=torch.float32, *, device=None) -> Dict[str, Params]:
    g1, g2, g3 = split_generator(gen, 3)
    p = {"up": dense_init(g2, d, d_ff, dtype, device=device),
         "down": dense_init(g3, d_ff, d, dtype, scale=1.0 / math.sqrt(d_ff),
                            device=device)}
    if act in ("silu", "swiglu"):
        p["gate"] = dense_init(g1, d, d_ff, dtype, device=device)
    return p


def mlp(p: Dict[str, Params], x: torch.Tensor,
        act: str = "silu") -> torch.Tensor:
    if act in ("silu", "swiglu"):
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return dense(p["down"], h)


def mlp_flops(tokens: int, d: int, d_ff: int, act: str = "silu") -> float:
    mults = 3 if act in ("silu", "swiglu") else 2
    return 2.0 * tokens * d * d_ff * mults


# -------------------------------------------------------------- conv (SSM) --
def causal_conv1d_init(gen: torch.Generator, channels: int, width: int,
                       dtype=torch.float32, *, device=None) -> Params:
    s = 1.0 / math.sqrt(width)
    dev = init_device(gen, device)
    u = torch.rand((width, channels), generator=gen, device=dev,
                   dtype=torch.float32)
    return {"w": (u * (2 * s) - s).to(dtype),
            "b": torch.zeros(channels, dtype=dtype, device=dev)}


def causal_conv1d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, S, C).  The taps are summed
    one by one in tap order, as in the JAX package (``F.conv1d`` sums in
    another order).  On DTensors each rank convolves its batch rows and
    channels (:func:`_by_channels`)."""
    if is_dtensor(x):
        return _by_channels(_conv, p["w"], p["b"], x)
    return _conv(p["w"], p["b"], x)


def _conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    w = w.to(x.dtype)                    # (W, C)
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):               # width is tiny (4); unrolled taps
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b.to(x.dtype)


def causal_conv1d_step(p: Params, x_t: torch.Tensor, window: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, C); window: (B, W-1, C) past inputs.
    Returns (y_t, new_window); on DTensors as :func:`causal_conv1d`."""
    if is_dtensor(x_t):
        return _by_channels(_conv_step, p["w"], p["b"], x_t, window)
    return _conv_step(p["w"], p["b"], x_t, window)


def _conv_step(w, b, x_t, window):
    w = w.to(x_t.dtype)                  # (W, C)
    full = torch.cat([window, x_t[:, None, :]], dim=1)   # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, w) + b.to(x_t.dtype)
    return y, full[:, 1:, :]


def _by_channels(fn, w, b, *acts):
    """``fn(w, b, *acts)`` on DTensor activations (batch first, channels
    last; one result placed as each), each rank on its batch rows where
    the mesh shards them and on its channels on ``model`` where it divides
    them: the conv is depthwise, so each rank computes its share as one
    device would.  The weight (W, C) and bias (C,) follow the channels,
    their taps whole (``w[i]`` never indexes a sharded dimension); a
    rank's gradient of them covers only its rows, so it is ``Partial`` on
    the axes that shard the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = acts[0]
    mesh = x.device_mesh
    axes = ["rows" if pl == Shard(0) else
            "channels" if name == "model" and x.shape[-1] % size == 0 else
            None for name, size, pl in zip(mesh.mesh_dim_names, mesh.shape,
                                           x.placements)]

    def placed(t, rows=True):
        return [Shard(0) if a == "rows" and rows else
                Shard(t.dim() - 1) if a == "channels" else Replicate()
                for a in axes]

    def grad(t):
        return [Partial() if a == "rows" else pl
                for a, pl in zip(axes, placed(t, rows=False))]
    acts = [a.redistribute(mesh, placed(a)) for a in acts]
    w, b = (t.redistribute(mesh, placed(t, rows=False)) for t in (w, b))
    outs = [placed(a) for a in acts]
    return on_shards(fn, outs[0] if len(outs) == 1 else tuple(outs), w, b,
                     *acts, in_grad_placements=[grad(w), grad(b)]
                     + [None] * len(acts))


# -------------------------------------------------------------------- loss --
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1, z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy; labels == ignore_id are masked out.

    On DTensor logits (sharded over the vocabulary on a process mesh) the
    gold logit is a one-hot sum over the sharded axis: each rank sums its
    slice of the classes, the partial sums add up to the one entry."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp(labels, min=0)
    if is_dtensor(logits):
        classes = replicate_like(
            torch.arange(logits.shape[-1], device=logits.device), logits)
        gold = torch.where(classes == safe[..., None], logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
