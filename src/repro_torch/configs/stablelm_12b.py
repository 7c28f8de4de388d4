"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  Family traits per the StableLM-2 card: LayerNorm, partial
rotary (25%), qkv biases.  [hf:stabilityai/stablelm-2-1_6b]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352, vocab_pad_to=256,
    norm="layernorm", act="silu", rope_fraction=0.25,
    rope_theta=10_000.0, qkv_bias=True,
    long_window=4096,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = FULL.replace(
    name="stablelm-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1, max_seq=512)

register(ArchEntry(arch_id="stablelm-12b", full=FULL, smoke=SMOKE))
