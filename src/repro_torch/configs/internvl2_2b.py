"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT (stub frontend) + InternLM2 decoder.
[arXiv:2404.16821]

The ViT + MLP projector frontend is a STUB per the assignment carve-out:
``input_specs`` supplies 256 precomputed patch embeddings (d_frontend=1024,
InternViT-300M width after pixel-shuffle) which a learned linear projector
maps into the LM; text tokens follow."""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553, vocab_pad_to=256,
    norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
    n_prefix=256, d_frontend=1024,
    long_window=4096,
    source="arXiv:2404.16821",
)

SMOKE = FULL.replace(
    name="internvl2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1, n_prefix=8,
    d_frontend=64, max_seq=512)

register(ArchEntry(arch_id="internvl2-2b", full=FULL, smoke=SMOKE))
