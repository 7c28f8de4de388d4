"""Shared neural-net layers as functional PyTorch.

Every layer is an (init, apply) pair of plain functions; params are nested
dicts of tensors with the JAX package's key paths.  An init function draws
from the ``torch.Generator`` it is given and puts its tensors on that
generator's device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import split_generator

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- norms --
def rmsnorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
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


def norm_init(kind: str, d: int, dtype=torch.float32, device="cpu") -> Params:
    return (layernorm_init(d, dtype, device) if kind == "layernorm"
            else rmsnorm_init(d, dtype, device))


def norm_apply(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)


# ----------------------------------------------------------------- linears --
def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None) -> Params:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": (_normal(gen, (d_in, d_out)) * s).to(dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Params:
    return {"table": (_normal(gen, (vocab, d)) * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    t = p["table"]
    if dtype is not None:
        t = t.to(dtype)
    return t[tokens.to(torch.int64)]


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
             dtype=torch.float32) -> Dict[str, Params]:
    g1, g2, g3 = split_generator(gen, 3)
    p = {"up": dense_init(g2, d, d_ff, dtype),
         "down": dense_init(g3, d_ff, d, dtype, scale=1.0 / math.sqrt(d_ff))}
    if act in ("silu", "swiglu"):
        p["gate"] = dense_init(g1, d, d_ff, dtype)
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


# -------------------------------------------------------------------- loss --
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1, z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy; labels == ignore_id are masked out."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
