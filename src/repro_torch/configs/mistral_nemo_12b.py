"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx (head_dim=128 fixed, not d_model/n_heads).
[hf:mistralai/Mistral-Nemo-Base-2407]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
    long_window=4096,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = FULL.replace(
    name="mistral-nemo-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1,
    max_seq=512)

register(ArchEntry(arch_id="mistral-nemo-12b", full=FULL, smoke=SMOKE))
