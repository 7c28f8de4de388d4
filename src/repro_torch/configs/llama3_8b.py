"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, GQA, 128k vocab.  [arXiv:2407.21783]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=500_000.0,
    long_window=4096,   # long_500k runs the SWA variant (DESIGN.md §5)
    source="arXiv:2407.21783",
)

SMOKE = FULL.replace(
    name="llama3-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1, max_seq=512)

register(ArchEntry(arch_id="llama3-8b", full=FULL, smoke=SMOKE))
