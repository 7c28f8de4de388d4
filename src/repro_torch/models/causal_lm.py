"""Decoder-only causal LM: the dense (GQA + SwiGLU/GELU) block.

Only what the OP-DAG training path runs is here: the dense block's init and
apply.  The MoE, SSM and xLSTM blocks, the scanned whole-model forward,
``prefill`` and ``decode_step`` come with later slices.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelCfg
from repro_torch.core.opgraph import split_generator
from . import attention as attn
from .layers import mlp, mlp_init, norm_apply, norm_init


# ==================================================================== init ==
def _dense_block_init(gen, cfg: ModelCfg):
    g1, g2 = split_generator(gen, 2)
    dev = gen.device
    return {"ln1": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
            "attn": attn.attn_init(g1, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.param_dtype, cfg.qkv_bias),
            "ln2": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
            "mlp": mlp_init(g2, cfg.d_model, cfg.d_ff, cfg.act,
                            cfg.param_dtype)}


# ============================================================ block apply ==
def _attn_kwargs(cfg: ModelCfg, window: Optional[int]):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, window=window,
                rope_fraction=cfg.rope_fraction, rope_theta=cfg.rope_theta)


def _dense_block(cfg, p, x, window):
    h = norm_apply(cfg.norm, p["ln1"], x)
    x = x + attn.attn_train(p["attn"], h, causal=True,
                            **_attn_kwargs(cfg, window))
    h = norm_apply(cfg.norm, p["ln2"], x)
    return x + mlp(p["mlp"], h, cfg.act)
