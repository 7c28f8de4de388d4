"""The benchmark's cells cut to a size the CPU runs in a second: every
structure kept (the cell's mode, plan, depth of the wire's chain, GQA
where the configuration has it), the widths and the batch shrunk."""
from portbench.harness import manifest

NAMES = tuple(w["name"] for w in manifest.manifest()["workloads"])


def small(name: str, layers: int = 4) -> dict:
    c = manifest.cell(name)
    cfg = dict(c["config"])
    gqa = cfg["n_kv_heads"] != cfg["n_heads"]
    cfg.update(n_layers=layers, d_model=64, n_heads=4,
               n_kv_heads=2 if gqa else 4, head_dim=16, d_ff=128, vocab=500,
               vocab_pad_to=256, max_seq=64)
    tr = dict(c["traffic"])
    tr.update(batch=4, seq=32)
    c["config"], c["traffic"] = cfg, tr
    return c
