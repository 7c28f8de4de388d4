"""The dense decoder block, as the published architectures describe it:
GPT-2's (LayerNorm, tanh GELU MLP) and Mistral's (RMSNorm, rotary
positions, grouped-query attention, SiLU-gated MLP).  Every layer is
alike.

A block family file declares, for layer ``i`` of configuration ``cfg``
(a configuration file's entries):

* ``block_specs(cfg, i)`` — ``(path under the block, shape, kind,
  scale)`` of each leaf, in the order of the program's parameter tree
  (``portbench.harness.weights`` says what kind and scale mean);
* ``block(cfg, p, x, i, split=False)`` — the reference forward of the
  layer on ``x`` (B, S, d) with its leaves ``p``: ``(output, term)``,
  ``term`` added to the model's loss (0.0 where the layer adds none);
  ``split`` re-associates one product, the same arithmetic in another
  order of additions (the rounding witness of ``calibrate.py``);
* ``block_flops(cfg, i, batch, seq)`` — the layer's forward FLOPs, counted
  as ``portbench.harness.yardstick`` says;
* ``small(cfg)`` — the configuration at a size the CPU runs in a second,
  every kind of layer kept.

It uses plain ``torch`` and ``math`` and the benchmark's own helpers, and
imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.harness.weights import norm_specs
from portbench.reference.model import norm, rotary


def block_specs(cfg: dict, i: int):
    d, dff = cfg["d_model"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    out = norm_specs(("ln1",), d, cfg)
    out += [(("attn", "wq", "w"), (d, q), "normal", 1 / math.sqrt(d)),
            (("attn", "wk", "w"), (d, kv), "normal", 1 / math.sqrt(d)),
            (("attn", "wv", "w"), (d, kv), "normal", 1 / math.sqrt(d)),
            (("attn", "wo", "w"), (q, d), "normal", 1 / math.sqrt(q))]
    out += norm_specs(("ln2",), d, cfg)
    out += [(("mlp", "up", "w"), (d, dff), "normal", 1 / math.sqrt(d)),
            (("mlp", "down", "w"), (dff, d), "normal", 1 / math.sqrt(dff))]
    if cfg["act"] == "silu":
        out.append((("mlp", "gate", "w"), (d, dff), "normal",
                    1 / math.sqrt(d)))
    return out


def attention(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    H, Hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = (x @ p["wq"]["w"].to(x.dtype)).view(B, S, H, hd)
    k = (x @ p["wk"]["w"].to(x.dtype)).view(B, S, Hkv, hd)
    v = (x @ p["wv"]["w"].to(x.dtype)).view(B, S, Hkv, hd)
    if cfg["rope_fraction"] > 0:
        q, k = rotary(q, cfg["rope_theta"]), rotary(k, cfg["rope_theta"])
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, hd)
    scores = (q @ k.transpose(-1, -2)).to(torch.float32) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = (probs @ v).transpose(1, 2).reshape(B, S, H * hd)
    return out @ p["wo"]["w"].to(x.dtype)


def mlp(cfg: dict, p: dict, x: torch.Tensor,
        split: bool = False) -> torch.Tensor:
    """The MLP; ``split`` sums the down projection over two halves of its
    inner dimension, the same product in another order of additions."""
    up = x @ p["up"]["w"].to(x.dtype)
    if cfg["act"] == "silu":
        h = F.silu(x @ p["gate"]["w"].to(x.dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    w = p["down"]["w"].to(x.dtype)
    if split:
        half = w.shape[0] // 2
        return h[..., :half] @ w[:half] + h[..., half:] @ w[half:]
    return h @ w


def block(cfg: dict, p: dict, x: torch.Tensor, i: int,
          split: bool = False):
    x = x + attention(cfg, p["attn"], norm(cfg, p["ln1"], x))
    return x + mlp(cfg, p["mlp"], norm(cfg, p["ln2"], x), split), 0.0


def matmul_params(cfg: dict) -> int:
    """Entries of the layer's weights a token goes through by a matrix
    product."""
    d, dff = cfg["d_model"], cfg["d_ff"]
    q = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv_heads"] * cfg["head_dim"]
    mlp_ = (3 if cfg["act"] == "silu" else 2) * d * dff
    return d * q + 2 * d * kv + q * d + mlp_


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward FLOPs of attention's two products, full square."""
    return 2 * 2.0 * batch * seq * seq * cfg["n_heads"] * cfg["head_dim"]


def block_flops(cfg: dict, i: int, batch: int, seq: int) -> float:
    return (2.0 * batch * seq * matmul_params(cfg)
            + attention_flops(cfg, batch, seq))


def small(cfg: dict) -> dict:
    """Four layers at width 64 (4 heads of 16; GQA kept as 2 key-value
    heads where the configuration has it), a 500-token vocabulary."""
    gqa = cfg["n_kv_heads"] != cfg["n_heads"]
    return dict(cfg, n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=2 if gqa else 4, head_dim=16, d_ff=128, vocab=500,
                vocab_pad_to=256, max_seq=64)
