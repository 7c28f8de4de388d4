"""OpGraph builders: models expressed in the FusionLLM OP-DAG IR.

These feed the decentralized runtime (scheduler → RAD executor → simulator):
* :func:`gpt_opgraph` — decoder-only transformer, one OP node per block
  (the paper's GPT-2 workload);
* :func:`profile_opgraph` — metadata-only transformer graph (flops/bytes
  per op, no apply functions) at any scale — e.g. the full GPT2-XL — for
  the latency simulator, which never executes compute.
"""
from __future__ import annotations

import numpy as np
import torch

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
        return {"ln": norm_init(cfg.norm, d, cfg.param_dtype, gen.device),
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
