"""The readings that the check's limits are set from, for one cell, in one
process: the program's numbers on many seeds, the control's (the
reference computed in bfloat16 in the program's place) and those of the
program with a fault planted in its timed path.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--faults half_batch dense_wire] \
        [--fault-seeds 1 2 3] [--out chiprun_out/calibrate.jsonl]

Each reading is one JSON line: ``{"kind": "program" | "control" |
<fault>, "seed": n, "numbers": {...}}``.  No window is measured: the
numbers come from the first steps that every run drives in its set-up.
``--witness-seeds`` reads the reference against itself with its MLP's
down projection re-associated: how far fp32 rounding alone moves them.
The state-left-unchanged fault reads 1 on the gradient and change gaps
by construction and is not run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from portbench.harness import cell, manifest
    from portbench.reference import compare
    from repro_torch.device import resolve_device
    entry = manifest.cell(args.workload)
    device = resolve_device("cuda")
    tr = entry["traffic"]
    sink = open(args.out, "a") if args.out else None

    def emit(kind, seed, nums, **extra):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": nums, **extra})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    refs = {}

    def reference(seed, batches):
        if seed not in refs:
            refs[seed] = cell.reference_readings(entry["config"], tr, seed,
                                                 batches, device)
        return refs[seed]

    def program(seed, fault=None):
        t = time.perf_counter()
        r = cell.Run(entry, seed, device, fault)
        plan, readings, batches = r.plan_diff(), r.readings, r.check_batches()
        r.free()
        ref = reference(seed, batches)
        nums = compare.numbers(readings, ref, plan)
        emit(fault or "program", seed, nums,
             seconds=time.perf_counter() - t, losses=readings["losses"],
             ref_losses=ref["losses"],
             worst_grad=compare.worst_leaves(readings["g1"], ref["g1"]),
             worst_change=compare.worst_leaves(readings["change"],
                                               ref["change"]))

    for seed in args.seeds:
        program(seed)
    for fault in args.faults:
        for seed in args.fault_seeds:
            program(seed, fault)
    for seed in args.control_seeds:
        batches = cell.check_batches(entry, seed, device)
        ref = reference(seed, batches)
        ctl = cell.reference_readings(entry["config"], tr, seed, batches,
                                      device, dtype=torch.bfloat16)
        emit("control", seed, compare.numbers(ctl, ref),
             losses=ctl["losses"], ref_losses=ref["losses"],
             worst_grad=compare.worst_leaves(ctl["g1"], ref["g1"]),
             worst_change=compare.worst_leaves(ctl["change"], ref["change"]))
        torch.cuda.empty_cache()
    for seed in args.witness_seeds:
        batches = cell.check_batches(entry, seed, device)
        ref = reference(seed, batches)
        wit = cell.reference_readings(entry["config"], tr, seed, batches,
                                      device, split=True)
        emit("witness", seed, compare.numbers(wit, ref),
             worst_grad=compare.worst_leaves(wit["g1"], ref["g1"]))
        torch.cuda.empty_cache()
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
