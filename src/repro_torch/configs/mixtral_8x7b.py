"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
    n_experts=8, top_k=2, window=4096, long_window=4096,
    moe_impl="capacity",
    source="arXiv:2401.04088",
)

SMOKE = FULL.replace(
    name="mixtral-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=128, vocab=512, vocab_pad_to=1, n_experts=4, top_k=2,
    window=64, long_window=64, moe_impl="ragged", max_seq=512)

register(ArchEntry(arch_id="mixtral-8x7b", full=FULL, smoke=SMOKE))
