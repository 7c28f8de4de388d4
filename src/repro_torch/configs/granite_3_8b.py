"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155, tied embeddings.  [hf:ibm-granite/granite-3.0-2b-base]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=10_000.0,
    tie_embeddings=True, long_window=4096,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = FULL.replace(
    name="granite-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1, max_seq=512)

register(ArchEntry(arch_id="granite-3-8b", full=FULL, smoke=SMOKE))
