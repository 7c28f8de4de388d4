"""The plain reference of a training step: the decoder's loss and
gradients in plain PyTorch, the wire's Top-K on each planned edge in both
directions, global-norm clipping where the traffic asks for it, and AdamW.

It follows the published architectures on the parameter trees the
benchmark makes (``portbench.harness.weights``): the embedding (learned
positions where the configuration has no rotary ones), the blocks of the
configuration's family (``portbench/families/<family>.py``, each layer's
forward and the term it adds to the loss), the head and the token
cross-entropy.  Departures, kept so that it computes the run's model:
the rotary pairs are adjacent dimensions (0, 1), (2, 3), ... (a fixed
permutation of the query and key columns from the published halves);
the fusion layout's head has its own norm and takes the padded vocabulary
into the softmax, the whole-model layout masks the padding.

A compressed edge carries ``x`` with, in each block of 4096 entries of the
flat tensor, all but the ``k`` largest magnitudes zeroed; ties at the k-th
magnitude are kept lowest index first, so exactly k survive.  The gradient
crossing the edge back is cut the same way with the same k.

Nothing here imports the program.  TF32 stays off.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.harness import manifest

BLOCK = 4096


# --------------------------------------------------------------- the wire --
def topk_blocks(x: torch.Tensor, k: int, block: int = BLOCK) -> torch.Tensor:
    """``x`` with all but the ``k`` largest magnitudes of each block of its
    flat entries zeroed (ties at the threshold kept in index order up to
    k); the last block is padded with zeros that take part."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // block)
    if nb * block != n:
        flat = torch.cat([flat, flat.new_zeros(nb * block - n)])
    tiles = flat.reshape(nb, block)
    mags = tiles.to(torch.float32).abs()
    thr = torch.topk(mags, k, dim=1).values[:, k - 1:k]
    above = mags > thr
    n_above = above.sum(dim=1, keepdim=True, dtype=torch.int32)
    tie = mags == thr
    rank = torch.cumsum(tie.to(torch.int32), dim=1, dtype=torch.int32)
    keep = above | (tie & (rank <= k - n_above))
    del mags, above, tie, rank
    out = torch.where(keep, tiles, tiles.new_zeros(()))
    return out.reshape(-1)[:n].reshape(x.shape)


class _Wire(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return topk_blocks(x, k)

    @staticmethod
    def backward(ctx, g):
        return topk_blocks(g, ctx.k), None


def wire(x: torch.Tensor, k: Optional[int]) -> torch.Tensor:
    return x if k is None else _Wire.apply(x, k)


# ---------------------------------------------------------------- layers --
def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.to(torch.float32), x.shape[-1:], eps=eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def rms_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def norm(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["norm"] == "layernorm":
        return layer_norm(p, x, cfg["norm_eps"])
    return rms_norm(p, x, cfg["norm_eps"])


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); adjacent pairs rotated by position times
    ``theta ** (-2i / hd)``."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv.to(torch.float32)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _unstack(tree):
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_unstack(tree[k]) for k in keys]
        return [dict(zip(keys, layer)) for layer in zip(*parts)]
    return list(torch.unbind(tree, 0))


def loss(cfg: dict, layout: str, params: dict, tokens: torch.Tensor,
         labels: torch.Tensor, edge_k: Dict[Tuple[str, str], int],
         dtype=torch.float32, split: bool = False) -> torch.Tensor:
    """Mean token cross-entropy of the model on ``tokens`` against
    ``labels``, plus the blocks' loss terms; the output of op ``a``
    crosses ``wire(., k)`` before op ``b`` for each ``(a, b): k`` in
    ``edge_k`` (fusion layout's op names: ``embed``, ``block_i``,
    ``head``, ``loss``)."""
    fam = manifest.family(cfg)
    S = tokens.shape[1]
    tok = tokens.to(torch.int64)
    L = cfg["n_layers"]
    names = ["embed"] + [f"block_{i}" for i in range(L)] + ["head", "loss"]
    after = {a: edge_k.get((a, b)) for a, b in zip(names[:-1], names[1:])}
    if layout == "fusion":
        emb = params["embed"]
        x = emb["tok"]["table"].to(dtype)[tok]
        if "pos" in emb:
            x = x + emb["pos"]["table"].to(dtype)[:S][None]
        blocks = [params[f"block_{i}"] for i in range(L)]
        head_norm, head_w = params["head"]["ln"], params["head"]["w"]["w"]
    else:
        x = params["embed"]["table"].to(dtype)[tok]
        if "pos_embed" in params:
            x = x + params["pos_embed"]["table"].to(dtype)[:S][None]
        blocks = _unstack(params["blocks"])
        head_norm, head_w = params["final_norm"], params["head"]["w"]
    x = wire(x, after["embed"])
    term = 0.0
    for i, p in enumerate(blocks):
        x, t = fam.block(cfg, p, x, i, split)
        x = wire(x, after[f"block_{i}"])
        term = term + t
    logits = norm(cfg, head_norm, x) @ head_w.to(dtype)
    if layout != "fusion" and logits.shape[-1] != cfg["vocab"]:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg["vocab"]
        logits = logits.masked_fill(pad, -1e30)
    logits = wire(logits, after["head"])
    return F.cross_entropy(logits.to(torch.float32).flatten(0, 1),
                           labels.to(torch.int64).flatten()) + term


# ------------------------------------------------------------ the update --
def leaves(tree, prefix: str = "") -> Iterable[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in the tree's order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v


def lr_at(traffic: dict, step: int) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine from the base
    rate to a tenth of it over the remaining ``total_steps``."""
    base, warm = traffic["lr"], traffic["warmup"]
    if step < warm:
        return base * (step + 1) / warm
    span = max(traffic["total_steps"] - warm, 1)
    t = min(step - warm, span) / span
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def train_readings(cfg: dict, layout: str, traffic: dict, params: dict,
                   batches: List[Tuple[torch.Tensor, torch.Tensor]],
                   edge_k: Dict[Tuple[str, str], int],
                   dtype=torch.float32, split: bool = False) -> dict:
    """Train ``params`` (float32 masters, updated in place) for
    ``len(batches)`` steps; the model computes in ``dtype``.  Returns the
    readings the comparison takes: each step's loss, each leaf's norm of
    the first step's gradient as AdamW gets it (after clipping), and each
    leaf's parameters' values, for the caller's change norms.  ``split``
    re-associates one product in each block (the family's; a witness of
    how far fp32 rounding alone moves the readings)."""
    named = list(leaves(params))
    for _, t in named:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    b1, b2, eps = traffic["b1"], traffic["b2"], traffic["eps"]
    wd, clip = traffic["weight_decay"], traffic.get("grad_clip", 0.0)
    losses, g1 = [], {}
    for s, (tokens, labels) in enumerate(batches):
        with torch.enable_grad():
            lo = loss(cfg, layout, params, tokens, labels, edge_k, dtype,
                      split)
        grads = torch.autograd.grad(lo, [t for _, t in named])
        losses.append(float(lo.detach()))
        del lo
        grads = [g.to(torch.float32) for g in grads]
        if clip:
            gn = torch.sqrt(sum(g.pow(2).sum() for g in grads))
            scale = torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)
        if s == 0:
            g1 = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
        lr = lr_at(traffic, s)
        bc1, bc2 = 1 - b1 ** (s + 1), 1 - b2 ** (s + 1)
        with torch.no_grad():
            for (_, p), g, m_, v_ in zip(named, grads, m, v):
                m_.mul_(b1).add_(g, alpha=1 - b1)
                v_.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m_ / bc1) / ((v_ / bc2).sqrt() + eps)
                if wd:
                    upd = upd + wd * p
                p.sub_(lr * upd)
        del grads
    for _, t in named:
        t.requires_grad_(False)
    del m, v
    return {"losses": losses, "g1": g1}


def change_norms(after: dict, before: dict) -> Dict[str, float]:
    """Each leaf's norm of ``after - before``."""
    b = dict(leaves(before))
    return {n: float((t - b[n]).norm()) for n, t in leaves(after)}
