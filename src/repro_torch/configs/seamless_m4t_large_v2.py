"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal.  [arXiv:2308.11596]

Interpretation (DESIGN.md §5): 24L = 12 encoder + 12 decoder transformer
layers.  The speech frontend (mel + w2v-BERT conv feature extractor) is a
STUB per the carve-out: ``input_specs`` supplies precomputed frame
embeddings (B, S_src, 1024).  long_500k is SKIPPED for this arch: an
enc-dec with a bounded source has no 500k-token decode regime."""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab=256206, vocab_pad_to=256,
    norm="layernorm", act="gelu", rope_theta=10_000.0,
    d_frontend=1024,
    source="arXiv:2308.11596",
)

SMOKE = FULL.replace(
    name="seamless-smoke", n_layers=2, n_enc_layers=1, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
    vocab_pad_to=1, d_frontend=64, max_seq=512)

register(ArchEntry(
    arch_id="seamless-m4t-large-v2", full=FULL, smoke=SMOKE,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: enc-dec with bounded source length "
               "(DESIGN.md §5)"))
