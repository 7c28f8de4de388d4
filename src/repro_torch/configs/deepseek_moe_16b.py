"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 experts top-6, 2 shared experts, fine-grained.
[arXiv:2401.06066]

Note: the reference model's first layer is a dense MLP; we keep all 28
layers MoE for uniform scan structure (bias < 2% of FLOPs, noted here for
fidelity accounting)."""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=10_000.0,
    n_experts=64, top_k=6, n_shared_experts=2,
    long_window=4096, moe_impl="capacity",
    source="arXiv:2401.06066",
)

SMOKE = FULL.replace(
    name="deepseek-moe-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=64, vocab=512, vocab_pad_to=1,
    n_experts=4, top_k=2, n_shared_experts=1, moe_impl="ragged", max_seq=512)

register(ArchEntry(arch_id="deepseek-moe-16b", full=FULL, smoke=SMOKE))
