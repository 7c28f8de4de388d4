"""xlstm-1.3b [ssm] — 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks at the paper's 7:1 ratio (one sLSTM per 8 blocks);
d_ff=0 because FFN capacity lives inside the blocks (mLSTM pre-up-projection
×2, sLSTM gated FFN ×4/3).  [arXiv:2405.04517]"""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="xlstm-1_3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304, vocab_pad_to=256,
    norm="rmsnorm", act="gelu", rope_fraction=1.0,  # rope unused by blocks
    slstm_every=8,
    long_window=None,   # native O(1)-state recurrent decode
    source="arXiv:2405.04517",
)

SMOKE = FULL.replace(
    name="xlstm-smoke", n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, vocab=512, vocab_pad_to=1, slstm_every=2, max_seq=512)

register(ArchEntry(arch_id="xlstm-1_3b", full=FULL, smoke=SMOKE))
