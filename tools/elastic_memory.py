#!/usr/bin/env python3
"""Where the elastic phase's card memory goes, on a CUDA card.

    python3 tools/elastic_memory.py [--top N] [--out FILE]

Runs ``chip_smoke.py``'s elastic path (gpt2-xl full through one CompNode
failure: joint planner, stop-the-world migration, AdamW, checkpoints every
3 steps) with the CUDA caching allocator's history recorded, Python stacks
included.  It replays the recorded allocations and frees to the moment the
bytes allocated peak, and prints one JSON object: the peak, the bytes
allocated when the recording started, and the blocks live at the peak
grouped by the innermost frame in this repository's code (file, line,
function), largest first, each with the outer repository frames of its
largest block.  ``--out`` writes the same object with every group.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MAX_EVENTS = 4_000_000       # the allocator's history ring


def repo_frames(frames) -> list:
    """This repository's frames of an allocation, innermost first (the
    stack is turned round when it starts at this script's own frame)."""
    if frames and Path(frames[0].get("filename", "")).resolve() == \
            Path(__file__).resolve():
        frames = frames[::-1]
    out = []
    for f in frames:
        name = f.get("filename", "")
        if str(ROOT) in name and "/tools/" not in name:
            out.append(f"{Path(name).relative_to(ROOT)}:{f['line']} "
                       f"{f['name']}")
    return out


def live_at_peak(events, base: int):
    """Replays allocator events; returns (peak bytes, {address: event} of
    the blocks live at the peak).  A block counts from its ``alloc`` to its
    ``free_completed``, as the allocator's allocated-bytes statistic
    does."""
    cur = peak = base
    peak_at = -1
    sizes = {}
    for i, ev in enumerate(events):
        if ev["action"] == "alloc":
            sizes[ev["addr"]] = ev["size"]
            cur += ev["size"]
            if cur > peak:
                peak, peak_at = cur, i
        elif ev["action"] == "free_completed":
            cur -= sizes.pop(ev["addr"], 0)
    live = {}
    for ev in events[:peak_at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    return peak, live


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("elastic_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import topk_compress as tk

    dev = resolve_device("cuda")
    print(cs.card_line())
    tk.build_library()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(max_entries=MAX_EVENTS,
                                             stacks="python")
    cs.run_elastic_path(dev)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)

    events = snap["device_traces"][torch.cuda.current_device()]
    if len(events) >= MAX_EVENTS:
        raise RuntimeError("the allocator's history ring overflowed: the "
                           "replay would miss the run's first events")
    peak, live = live_at_peak(events, base)
    groups = {}
    for ev in live.values():
        frames = repo_frames(ev.get("frames", []))
        key = frames[0] if frames else "(outside the repository)"
        g = groups.setdefault(key, {"bytes": 0, "blocks": 0, "largest": 0,
                                    "outer": []})
        g["bytes"] += ev["size"]
        g["blocks"] += 1
        if ev["size"] > g["largest"]:
            g["largest"], g["outer"] = ev["size"], frames[1:6]
    table = sorted(({"frame": k, "gb": g["bytes"] / 1e9,
                     "blocks": g["blocks"], "outer": g["outer"]}
                    for k, g in groups.items()), key=lambda r: -r["gb"])
    result = {"peak_allocated_gb": peak / 1e9,
              "allocated_at_start_gb": base / 1e9,
              "events": len(events),
              "live_at_peak_gb": sum(ev["size"] for ev in live.values())
              / 1e9, "groups": table}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({**result, "groups": table[:args.top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
