"""Multi-pod dry run: every (architecture × input shape) step assembled on
the production mesh, with nothing allocated.

For every arch × shape the port's
:func:`~repro_torch.distributed.steps.build_jitted` assembles the step on
the production mesh — 16×16 single pod AND 2×16×16 multi-pod — with
``meta`` tensors as arguments.  That mesh holds no devices, so nothing is
placed or allocated anywhere: this is the port's one entry point that
needs no card (and takes no ``--device``).  The JAX package's dry run does
the same against 512 forced host devices with abstract inputs, and then
lowers and compiles the step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both

Each record keeps the JAX package's keys and file name
(``{arch}__{shape}__{mesh}[__unroll][__overrides].json``), and holds what
follows exactly from the shardings and shapes:

* ``status`` — ``ok``, ``skipped`` (the registry skips the shape) or
  ``fail`` (the exception and its traceback are recorded);
* ``mem.argument_bytes`` — per device: over every argument leaf, the
  element count of its ``NamedSharding.shard_shape`` times its itemsize;
* ``model_flops_total`` — :func:`repro_torch.analysis.model_flops`.

Every field only XLA's compile gives (:data:`NOT_MEASURED`) is ``None``,
and ``not_measured`` names them: no compiler partitions the eager step,
so there is no memory plan, cost analysis, collective schedule or module
text to read, and no stand-in number is put in their place.

Sweep progress is reported as :mod:`repro_torch.obs.slog` structured
events (``--log-level``/``--quiet`` apply); the default ``--out`` is
``experiments/dryrun_torch``, apart from the JAX package's artifacts.
"""
import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

# the record's fields that only a compiler's analysis of the partitioned
# step gives; "mem.x" is the key x of the record's "mem" entry
NOT_MEASURED = (
    "mem.output_bytes", "mem.temp_bytes", "mem.alias_bytes",
    "mem.peak_per_device", "flops_per_device", "bytes_per_device",
    "collective_bytes_per_device", "collective_breakdown", "lower_s",
    "compile_s", "roofline", "hlo_path",
)
NOT_MEASURED_WHY = ("no compiler partitions the eager step: PyTorch runs "
                    "it as written, with no memory plan, cost analysis, "
                    "collective schedule or module text to read")


def record_path(out_dir: str, arch_id: str, shape_name: str, mesh_name: str,
                unroll: bool = False,
                overrides_name: Optional[str] = None) -> str:
    suffix = ("__unroll" if unroll else "") + \
        (f"__{overrides_name}" if overrides_name else "")
    return os.path.join(
        out_dir, f"{arch_id}__{shape_name}__{mesh_name}{suffix}.json")


def argument_bytes(args: Any, in_shardings: Any) -> int:
    """Per-device bytes of the step's arguments: for every leaf, the
    element count of its shard shape times the leaf's itemsize."""
    from repro_torch.distributed.params import (tree_map_with_path,
                                                tree_path_str)

    def flat(tree):
        out: Dict[str, Any] = {}
        tree_map_with_path(
            lambda p, leaf: out.__setitem__(tree_path_str(p), leaf), tree)
        return out

    leaves, shardings = flat(args), flat(in_shardings)
    if leaves.keys() != shardings.keys():
        raise ValueError(f"arguments and shardings differ in tree: "
                         f"{sorted(leaves.keys() ^ shardings.keys())[:4]}")
    total = 0
    for key, leaf in leaves.items():
        shard = shardings[key].shard_shape(tuple(leaf.shape))
        total += math.prod(shard) * leaf.element_size()
    return total


def run_one(arch_id: str, shape_name: str, multi_pod: bool,
            out_dir: Optional[str] = None, save_hlo: bool = False,
            unroll: bool = False, overrides_name: Optional[str] = None,
            dtype: str = "bfloat16") -> dict:
    """One record: the step assembled for ``arch_id`` × ``shape_name`` on
    the production mesh (``multi_pod`` for 2×16×16), written to
    ``out_dir`` when given.  ``save_hlo`` saves nothing: there is no module
    text (``hlo_path`` stays ``None``)."""
    del save_hlo
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs import INPUT_SHAPES, resolve
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.scan_config import set_unroll
    from repro_torch.perf import overrides as perf_overrides

    entry = resolve(arch_id)
    shape = INPUT_SHAPES[shape_name]
    if shape_name not in entry.shapes:
        return {"arch": arch_id, "shape": shape_name, "status": "skipped",
                "note": entry.skip_notes}
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cfg = entry.full.replace(dtype=dt, param_dtype=dt,
                             remat=(shape.kind == "train"))
    povr = perf_overrides.get(overrides_name) if overrides_name else None
    if povr and povr.get("cfg"):
        cfg = cfg.replace(**povr["cfg"])
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "chips": mesh.size, "kind": shape.kind, "unroll": bool(unroll)}
    t0 = time.time()
    try:
        rules = {}
        if shape.global_batch < mesh.shape.get("data", 1):
            rules["batch"] = None
        rules.update((povr or {}).get("rules", {}))
        with use_mesh(mesh, rules), set_unroll(True if unroll else 1):
            _fn, args, meta = build_jitted(
                cfg, mesh, shape,
                param_overrides=(povr or {}).get("param_overrides"))
        rec.update({
            "status": "ok",
            "lower_s": None,
            "compile_s": None,
            "mem": {
                "argument_bytes": argument_bytes(args,
                                                 meta["in_shardings"]),
                "output_bytes": None,
                "temp_bytes": None,
                "alias_bytes": None,
                "peak_per_device": None,
            },
            "flops_per_device": None,
            "bytes_per_device": None,
            "collective_bytes_per_device": None,
            "collective_breakdown": None,
            "model_flops_total": model_flops(cfg, shape),
            "roofline": None,
            "hlo_path": None,
            "not_measured": {"fields": list(NOT_MEASURED),
                             "why": NOT_MEASURED_WHY},
        })
    except Exception as e:  # noqa: BLE001 — record and keep sweeping
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-3000:]})
    rec["total_s"] = round(time.time() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = record_path(out_dir, arch_id, shape_name, mesh_name, unroll,
                           overrides_name)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def main() -> None:
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs import slog

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="accepted for the JAX package's callers; the "
                         "port compiles no module text to save")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the JAX package's callers; the "
                         "port's layer loops have nothing to unroll")
    ap.add_argument("--overrides", default=None,
                    help="named perf-override set "
                         "(repro_torch.perf.overrides)")
    ap.add_argument("--skip-existing", action="store_true")
    slog.add_logging_args(ap)
    args = ap.parse_args()
    log = slog.get_logger("dryrun", metrics=MetricsRegistry(),
                          level=slog.level_from_args(args))

    assigned = [a for a in ARCH_IDS if a != "gpt2-xl"]
    archs = assigned if (args.all or not args.arch) else [args.arch]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                mesh_name = "2x16x16" if mp else "16x16"
                if args.skip_existing and os.path.exists(record_path(
                        args.out, arch, shape, mesh_name, args.unroll,
                        args.overrides)):
                    log.event("dryrun_cached", arch=arch, shape=shape,
                              mesh=mesh_name)
                    continue
                rec = run_one(arch, shape, mp, args.out, args.save_hlo,
                              args.unroll, args.overrides)
                results.append(rec)
                if rec["status"] == "ok":
                    log.event("dryrun_ok", arch=arch, shape=shape,
                              mesh=mesh_name, total_s=rec["total_s"],
                              arg_gib=rec["mem"]["argument_bytes"] / 2**30)
                elif rec["status"] == "skipped":
                    log.event("dryrun_skip", arch=arch, shape=shape,
                              mesh=mesh_name, note=rec["note"][:60])
                else:
                    log.error("dryrun_fail", arch=arch, shape=shape,
                              mesh=mesh_name, error=rec["error"][:140])
    n_fail = sum(r["status"] == "fail" for r in results)
    log.event("dryrun_done", runs=len(results), failures=n_fail)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
