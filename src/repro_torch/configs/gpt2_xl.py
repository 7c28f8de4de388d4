"""gpt2-xl — the paper's own workload (FusionLLM Table 6): 48L d_model=1600
25H d_ff=6400 vocab=50257, learned positional embeddings, LayerNorm + GELU.
[Radford et al. 2019]

Not part of the assigned 10×4 matrix; used by the paper-reproduction
benchmarks (Fig. 8/10/11) and the decentralized-runtime examples."""
from .base import ArchEntry, ModelCfg, register

FULL = ModelCfg(
    name="gpt2-xl", family="dense",
    n_layers=48, d_model=1600, n_heads=25, n_kv_heads=25, head_dim=64,
    d_ff=6400, vocab=50257, vocab_pad_to=256,
    norm="layernorm", act="gelu", rope_fraction=0.0, max_seq=1024,
    source="GPT-2 (Radford et al. 2019); FusionLLM Table 6",
)

SMOKE = FULL.replace(
    name="gpt2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, vocab_pad_to=1, max_seq=512)

register(ArchEntry(arch_id="gpt2-xl", full=FULL, smoke=SMOKE,
                   shapes=("train_4k",),
                   skip_notes="paper workload, not in the assigned matrix; "
                              "max_seq=1024 (learned pos-emb)"))
