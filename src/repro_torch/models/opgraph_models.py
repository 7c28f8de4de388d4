"""OpGraph builders: models expressed in the FusionLLM OP-DAG IR.

These feed the decentralized runtime (scheduler → RAD executor → simulator):
* :func:`gpt_opgraph` — decoder-only transformer, one OP node per block
  (the paper's GPT-2 workload);
* :func:`convnet_opgraph` — small CNN classifier (stand-in for the paper's
  ResNet-101 / CIFAR-10 workload);
* :func:`profile_opgraph` — metadata-only transformer graph (flops/bytes
  per op, no apply functions) at any scale — e.g. the full GPT2-XL — for
  the latency simulator, which never executes compute.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelCfg
from repro_torch.core.opgraph import OpGraph, OpNode, OpType, split_generator
from .attention import attn_flops
from .causal_lm import _dense_block, _dense_block_init
from .layers import (cross_entropy, dense, dense_init, embed, embed_init,
                     mlp_flops, norm_apply, norm_init)


def gpt_opgraph(cfg: ModelCfg, batch: int, seq: int) -> OpGraph:
    """Executable OP-DAG: tokens -> embed -> block_0..L-1 -> head -> loss."""
    g = OpGraph(f"{cfg.name}-opdag")
    g.add(OpNode("tokens", OpType.PLACEHOLDER))
    g.add(OpNode("labels", OpType.PLACEHOLDER))
    d, V = cfg.d_model, cfg.vocab_padded

    def embed_init_fn(gen, tok_shape):
        g1, g2 = split_generator(gen, 2)
        p = {"tok": embed_init(g1, V, d, cfg.param_dtype)}
        if cfg.rope_fraction == 0.0:
            p["pos"] = embed_init(g2, cfg.max_seq, d, cfg.param_dtype)
        return p

    def embed_apply(p, tokens):
        x = embed(p["tok"], tokens, cfg.dtype)
        if "pos" in p:
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            x = x + embed(p["pos"], pos, cfg.dtype)[None]
        return x

    g.add(OpNode("embed", OpType.PARAMETRIC, args=("tokens",),
                 init_fn=embed_init_fn, apply_fn=embed_apply,
                 out_shape_fn=lambda s: (s[0], s[1], d),
                 flops_fn=lambda s: 0.0,
                 n_params_fn=lambda s: V * d + (cfg.max_seq * d
                                                if cfg.rope_fraction == 0.0
                                                else 0)))
    prev = "embed"
    blk_flops = (attn_flops(batch * seq, seq, d, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim)
                 + mlp_flops(batch * seq, d, cfg.d_ff, cfg.act))
    for i in range(cfg.n_layers):
        name = f"block_{i}"
        g.add(OpNode(
            name, OpType.PARAMETRIC, args=(prev,),
            init_fn=lambda gen, s: _dense_block_init(gen, cfg),
            apply_fn=lambda p, x: _dense_block(cfg, p, x, cfg.window),
            out_shape_fn=lambda s: s,
            flops_fn=lambda s, f=blk_flops: f,
            n_params_fn=lambda s: _count_block_params(cfg)))
        prev = name

    def head_init(gen, s):
        return {"ln": norm_init(cfg.norm, d, cfg.param_dtype, device=gen.device),
                "w": dense_init(gen, d, V, cfg.param_dtype, scale=0.02)}

    g.add(OpNode("head", OpType.PARAMETRIC, args=(prev,),
                 init_fn=head_init,
                 apply_fn=lambda p, x: dense(
                     {"w": p["w"]["w"]}, norm_apply(cfg.norm, p["ln"], x)),
                 out_shape_fn=lambda s: (s[0], s[1], V),
                 flops_fn=lambda s: 2.0 * s[0] * s[1] * d * V,
                 n_params_fn=lambda s: d * V
                 + (2 * d if cfg.norm == "layernorm" else d)))
    g.add(OpNode("loss", OpType.LOSS, args=("head", "labels"),
                 apply_fn=lambda p, logits, y: cross_entropy(logits, y),
                 out_shape_fn=lambda a, b: (),
                 flops_fn=lambda a, b: float(np.prod(a))))
    return g


def _count_block_params(cfg: ModelCfg) -> int:
    d = cfg.d_model
    nrm = 2 * d if cfg.norm == "layernorm" else d
    attn_p = d * cfg.n_heads * cfg.head_dim * 2 \
        + d * cfg.n_kv_heads * cfg.head_dim * 2
    mults = 3 if cfg.act in ("silu", "swiglu") else 2
    return attn_p + d * cfg.d_ff * mults + 2 * nrm


def _same_pad(size: int, stride: int, kernel: int):
    """XLA's ``"SAME"`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_same_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv_general_dilated(x, w, (2, 2), "SAME")`` in NHWC/HWIO.  SAME
    pads the high side first when the total is odd ((0, 1) at hw 16), so
    the padding is explicit: ``padding=1`` would pad (1, 1)."""
    (ht, hb), (wl, wr) = (_same_pad(x.shape[1], 2, w.shape[0]),
                          _same_pad(x.shape[2], 2, w.shape[1]))
    xp = F.pad(x.permute(0, 3, 1, 2), (wl, wr, ht, hb))
    y = F.conv2d(xp, w.to(x.dtype).permute(3, 2, 0, 1), stride=2)
    return y.permute(0, 2, 3, 1)


def convnet_opgraph(hw: int = 16, channels: int = 3, n_classes: int = 10,
                    widths=(16, 32, 64), dtype=torch.float32) -> OpGraph:
    """Small CNN classifier as an OP-DAG (CV stand-in for ResNet)."""
    g = OpGraph("convnet-opdag")
    g.add(OpNode("images", OpType.PLACEHOLDER))
    g.add(OpNode("labels", OpType.PLACEHOLDER))
    prev, c_in, cur_hw = "images", channels, hw
    for i, c_out in enumerate(widths):
        name = f"conv_{i}"

        def init_fn(gen, s, ci=c_in, co=c_out):
            w = torch.randn((3, 3, ci, co), generator=gen, device=gen.device)
            return {"w": (w * (1.0 / math.sqrt(9 * ci))).to(dtype),
                    "b": torch.zeros(co, dtype=dtype, device=gen.device)}

        def apply_fn(p, x):
            return F.relu(_conv_same_s2(x, p["w"]) + p["b"])

        out_hw = -(-cur_hw // 2)
        g.add(OpNode(name, OpType.PARAMETRIC, args=(prev,),
                     init_fn=init_fn, apply_fn=apply_fn,
                     out_shape_fn=lambda s, oh=out_hw, co=c_out:
                         (s[0], oh, oh, co),
                     flops_fn=lambda s, ci=c_in, co=c_out, oh=out_hw:
                         2.0 * s[0] * oh * oh * 9 * ci * co,
                     n_params_fn=lambda s, ci=c_in, co=c_out:
                         9 * ci * co + co))
        prev, c_in, cur_hw = name, c_out, out_hw
    g.add(OpNode("pool", OpType.NON_PARAMETRIC, args=(prev,),
                 apply_fn=lambda p, x: torch.mean(x, dim=(1, 2)),
                 out_shape_fn=lambda s: (s[0], s[3]),
                 flops_fn=lambda s: float(np.prod(s))))
    g.add(OpNode("fc", OpType.PARAMETRIC, args=("pool",),
                 init_fn=lambda gen, s: dense_init(gen, widths[-1], n_classes,
                                                   dtype),
                 apply_fn=lambda p, x: dense(p, x),
                 out_shape_fn=lambda s: (s[0], n_classes),
                 flops_fn=lambda s: 2.0 * s[0] * widths[-1] * n_classes,
                 n_params_fn=lambda s: widths[-1] * n_classes))
    g.add(OpNode("loss", OpType.LOSS, args=("fc", "labels"),
                 apply_fn=lambda p, logits, y: cross_entropy(logits, y),
                 out_shape_fn=lambda a, b: ()))
    return g


def profile_opgraph(cfg: ModelCfg, batch: int, seq: int) -> OpGraph:
    """Metadata-only graph (no apply fns) for the latency simulator —
    builds the FULL-size model's cost profile without allocating it."""
    g = OpGraph(f"{cfg.name}-profile")
    g.add(OpNode("tokens", OpType.PLACEHOLDER))
    g.add(OpNode("labels", OpType.PLACEHOLDER))
    d = cfg.d_model
    g.add(OpNode("embed", OpType.PARAMETRIC, args=("tokens",),
                 out_shape_fn=lambda s: (s[0], s[1], d),
                 flops_fn=lambda s: 0.0,
                 n_params_fn=lambda s: cfg.vocab_padded * d))
    prev = "embed"
    for i in range(cfg.n_layers):
        name = f"block_{i}"
        g.add(OpNode(name, OpType.PARAMETRIC, args=(prev,),
                     out_shape_fn=lambda s: s,
                     flops_fn=lambda s: (
                         attn_flops(s[0] * s[1], s[1], d, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim)
                         + mlp_flops(s[0] * s[1], d, cfg.d_ff, cfg.act)),
                     n_params_fn=lambda s: _count_block_params(cfg)))
        prev = name
    g.add(OpNode("head", OpType.PARAMETRIC, args=(prev,),
                 out_shape_fn=lambda s: (s[0], s[1], cfg.vocab_padded),
                 flops_fn=lambda s: 2.0 * s[0] * s[1] * d * cfg.vocab_padded,
                 n_params_fn=lambda s: d * cfg.vocab_padded))
    g.add(OpNode("loss", OpType.LOSS, args=("head", "labels"),
                 out_shape_fn=lambda a, b: (),
                 flops_fn=lambda a, b: float(np.prod(a))))
    return g
