"""Analytic MODEL_FLOPS per (arch × input shape).

MODEL_FLOPS counts only the mathematically necessary work: matmul-type ops
of the architecture itself, causal attention at S·(S+1)/2 score pairs, MoE
at active (top-k) expert FLOPs — 6·N·D-style accounting generalized to
every family.  Training = 3× forward (fwd + 2×bwd).  The arithmetic is the
JAX package's (``repro.analysis.model_flops``) line for line, so the two
packages give the same numbers for every arch × shape.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelCfg
from repro_torch.distributed.steps import decode_window
from repro_torch.models import causal_lm, encdec
from repro_torch.models.attention import attn_flops
from repro_torch.models.layers import mlp_flops
from repro_torch.models.moe import moe_flops
from repro_torch.models.ssm import mamba_flops
from repro_torch.models.xlstm import mlstm_flops, slstm_flops


def _attn(tokens: float, kv: float, cfg: ModelCfg, causal: bool) -> float:
    f = attn_flops(int(tokens), int(kv), cfg.d_model, cfg.n_heads,
                   cfg.n_kv_heads, cfg.head_dim)
    if causal:
        # remove half the score/value FLOPs (lower-triangular work only)
        scores = 2.0 * 2.0 * tokens * kv * cfg.n_heads * cfg.head_dim
        f -= scores / 2.0
    return f


def forward_flops(cfg: ModelCfg, batch: int, seq: int,
                  kv_len: float = None, decode: bool = False) -> float:
    """Whole-model forward FLOPs for ``batch`` sequences of ``seq`` new
    tokens (decode: seq=1, kv_len = cache depth)."""
    T = float(batch * seq)
    kv = float(kv_len if kv_len is not None else seq)
    eff_window = cfg.window or kv
    attn_kv = min(kv, eff_window)
    total = 2.0 * T * cfg.d_model * cfg.vocab_padded          # head

    if cfg.family == "encdec":
        # a decode takes the source length to be the cache depth
        # (``kv_len``), not ``src_len_for``: kept as the reference has it,
        # so the two packages' numbers stay equal
        S_src = kv_len if decode else max(seq // 8, 16)
        Tsrc = float(batch * S_src)
        per_enc = _attn(Tsrc, S_src, cfg, causal=False) \
            + mlp_flops(Tsrc, cfg.d_model, cfg.d_ff, cfg.act)
        per_dec = _attn(T, kv, cfg, causal=not decode) \
            + _attn(T, S_src, cfg, causal=False) \
            + mlp_flops(T, cfg.d_model, cfg.d_ff, cfg.act)
        enc = cfg.n_enc_layers * per_enc if not decode else 0.0
        return total + enc + cfg.n_dec_layers * per_dec

    if cfg.n_prefix and not decode:
        T = float(batch * (seq + cfg.n_prefix))
        kv = float(seq + cfg.n_prefix)
        total += 2.0 * batch * cfg.n_prefix * cfg.d_frontend * cfg.d_model

    for seg in causal_lm.segments(cfg):
        if seg.kind == "dense":
            per = _attn(T, attn_kv, cfg, causal=not decode) \
                + mlp_flops(T, cfg.d_model, cfg.d_ff, cfg.act)
            total += seg.count * per
        elif seg.kind == "moe":
            shared_ff = cfg.n_shared_experts * cfg.d_ff
            per = _attn(T, attn_kv, cfg, causal=not decode) \
                + moe_flops(T, cfg.d_model, cfg.d_ff, cfg.top_k, shared_ff)
            total += seg.count * per
        elif seg.kind in ("mamba",):
            total += seg.count * mamba_flops(T, causal_lm._mamba_cfg(cfg))
        elif seg.kind == "mlstm":
            total += seg.count * mlstm_flops(T, int(kv),
                                             causal_lm._xlstm_cfg(cfg))
        elif seg.kind == "zamba_group":
            mam = seg.inner * mamba_flops(T, causal_lm._mamba_cfg(cfg))
            sh = _attn(T, kv, cfg, causal=not decode) \
                + (mlp_flops(T, cfg.d_model, cfg.d_ff, cfg.act)
                   if cfg.d_ff else 0.0)
            total += seg.count * (mam + sh)
        elif seg.kind == "xlstm_group":
            xc = causal_lm._xlstm_cfg(cfg)
            total += seg.count * ((seg.inner - 1) * mlstm_flops(T, int(kv), xc)
                                  + slstm_flops(T, xc))
    return total


def model_flops(cfg: ModelCfg, shape: InputShape) -> float:
    """MODEL_FLOPS for one step of the shape's kind."""
    if shape.kind == "train":
        fwd = forward_flops(cfg, shape.global_batch, shape.seq_len)
        return 3.0 * fwd
    if shape.kind == "prefill":
        return forward_flops(cfg, shape.global_batch, shape.seq_len)
    # decode: one token, cache depth = seq_len
    w = decode_window(cfg, shape)
    kv = min(shape.seq_len, w) if w else shape.seq_len
    return forward_flops(cfg, shape.global_batch, 1, kv_len=kv, decode=True)


def six_nd(cfg: ModelCfg, tokens: float) -> float:
    """Classic 6·N·D (N = matmul params; MoE uses active params)."""
    if cfg.family == "encdec":
        n = encdec.count_params(cfg)
    else:
        n = causal_lm.count_params(cfg)
        n -= cfg.vocab_padded * cfg.d_model      # embed lookup isn't matmul
        if cfg.rope_fraction == 0.0:
            n -= cfg.max_seq * cfg.d_model
        if cfg.tie_embeddings:
            n += cfg.vocab_padded * cfg.d_model  # head matmul still happens
    if cfg.family == "moe":
        inactive = (cfg.n_experts - cfg.top_k) * cfg.d_model * cfg.d_ff * 3
        n -= cfg.n_layers * inactive
    return 6.0 * n * tokens
