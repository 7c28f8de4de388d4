"""The program's spans in one cell's traced window: for each span that
``repro_torch`` opens on its training path, its device ms, launches and
idle ms a step, and the readings built from them.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

Run from the root of a checkout, on a CUDA device.  It sets the cell up
as ``run.py`` does, trains one window untraced and then one under
``torch.profiler`` with the benchmark's own spans on (as a ``--trace 1``
run does), and prints one JSON line: the device, each window's steps and
tokens a second, ``readings`` (``update_device_ms``, ``update_launches``,
``executor_idle_ms`` and ``attn_ms``, with the benchmark spans'
``executor_ms`` and ``update_ms`` and the idle share beside them) and
``spans``, each span name keyed to its figures a step
(``harness/spans.SpanTrace.table``).  On a program that opens no spans
``readings`` holds the benchmark spans' alone.  No check is made.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def traced_window(run, seconds: float):
    """``run``'s window under the profiler: (steps, seconds, its events)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            steps, failed, window_s = run.window(seconds, True)
    if failed:
        raise RuntimeError(f"{failed} of {steps} traced steps failed")
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / "spans-trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return steps, window_s, events


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    import torch
    from portbench.harness import cell, manifest, spans
    entry = manifest.cell(args.workload)
    tr = entry["traffic"]
    device = torch.device("cuda", 0)
    run = cell.Run(entry, args.seed % (2 ** 63), device)
    tokens = tr["batch"] * tr["seq"]
    steps, failed, window_s = run.window(args.seconds)
    if failed:
        raise RuntimeError(f"{failed} of {steps} steps failed")
    untraced = {"steps": steps, "tokens_per_s": steps * tokens / window_s}
    t_steps, t_window_s, events = traced_window(run, args.seconds)
    trace = spans.SpanTrace(events)
    del events
    got = spans.readings(trace, t_steps)
    for name, values in run.prog.spans.items():
        if values:
            got[f"{name}_ms"] = 1e3 * sum(values) / len(values)
    got["device_idle_pct"] = 100.0 * (1.0 - trace.busy_s / trace.window_s)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device),
        "untraced": untraced,
        "traced": {"steps": t_steps,
                   "tokens_per_s": t_steps * tokens / t_window_s},
        "readings": got, "spans": trace.table(t_steps)}))


if __name__ == "__main__":
    main()
