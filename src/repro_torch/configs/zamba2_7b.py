"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
(2 alternating shared blocks, one invocation every 6 Mamba layers; the
assigned d_ff belongs to the shared block's MLP).  [arXiv:2411.15242]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=10_000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    attn_every=6, n_shared_attn=2,
    long_window=None,    # SSM state is O(1); shared attn keeps full KV
    source="arXiv:2411.15242",
)

SMOKE = FULL.replace(
    name="zamba2-smoke", n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=8, attn_every=2,
    n_shared_attn=2, max_seq=512)

register(ArchEntry(arch_id="zamba2-7b", full=FULL, smoke=SMOKE))
