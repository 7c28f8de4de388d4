"""The benchmark's cells cut to a size the CPU runs in a second: every
structure kept (the cell's mode, plan, depth of the wire's chain, every
kind of layer), the configuration cut by its family's ``small`` and the
batch shrunk."""
from portbench.harness import manifest

NAMES = tuple(w["name"] for w in manifest.manifest()["workloads"])


def small(name: str) -> dict:
    c = manifest.cell(name)
    cfg = manifest.family(c["config"]).small(c["config"])
    tr = dict(c["traffic"])
    tr.update(batch=4, seq=32)
    c["config"], c["traffic"] = cfg, tr
    return c
