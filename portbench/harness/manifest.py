"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; each names
a configuration (``configs`` gives its file) and a traffic mix
(``portbench/traffic/<traffic>.json``).  A cell's limits for the check of
its output are ``portbench/limits/<cell>.json``; a per-layer metric is the
module ``portbench/metrics/<metric>.py``; the blocks of a configuration
whose ``family`` is ``f`` are the module ``portbench/families/<f>.py``.
Adding a cell, a mix, a metric or a block family adds files; nothing here
changes.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> Dict[str, object]:
    """The cell ``name``: its manifest entry, configuration, traffic,
    limits and the end-to-end and per-layer metric entries it reports."""
    m = manifest(root)
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    bench = root / "portbench"

    def here(entry):
        return name in entry.get("workloads", [name])
    return {"workload": w,
            "config": _load(root / conf["file"]),
            "traffic": _load(bench / "traffic" / f"{w['traffic']}.json"),
            "limits": _load(bench / "limits" / f"{name}.json"),
            "end_to_end": [e for e in m["end_to_end"] if here(e)],
            "per_layer": [e for e in m["per_layer"] if here(e)]}


def _module(folder: str, name: str, root: Path):
    path = root / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: Path = ROOT):
    """The reader of per-layer metric ``name``."""
    return _module("metrics", name, root)


@functools.lru_cache(maxsize=None)
def family_module(name: str, root: Path = ROOT):
    """The block family ``name``: ``block_specs``, ``block``,
    ``block_flops`` and ``small`` of its layers; read once a process."""
    return _module("families", name, root)


def family(cfg: dict, root: Path = ROOT):
    """The block family of configuration ``cfg``, named by its ``family``
    key."""
    return family_module(cfg["family"], root)


def metric_names(root: Path = ROOT) -> List[str]:
    return sorted(p.stem for p in (root / "portbench" / "metrics").glob("*.py"))
