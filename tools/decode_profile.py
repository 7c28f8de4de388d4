#!/usr/bin/env python3
"""Where one decode step spends its time, on a CUDA card.

    python3 tools/decode_profile.py [--arch A] [--batch B] [--reps N] [--top K]

Builds ``--arch`` (gpt2-xl, the default, zamba2-7b, xlstm-1_3b or
seamless-m4t-large-v2) at full width and depth (random weights from seed 0,
fp32, TF32 off) on the card, prefills the prompt ``chip_smoke.py``'s phase
for that model uses into its cache (gpt2-xl: 12 tokens into 64 slots;
zamba2-7b: 128 tokens, one SSD chunk, into 512; xlstm-1_3b: 128 tokens into
its recurrent states, which take no cache length; seamless-m4t-large-v2: an
8-token target prefix into 512 slots over ``steps.src_len_for(cfg, 512)``
= 64 frame embeddings drawn with numpy from seed 0), and runs the model's
``decode_step`` (``steps.make_decode_step``) ``--reps`` times under
``torch.profiler`` (CPU and CUDA activity).  It prints one JSON
object: the step's span from CUDA events and its host time (both per
step, median), the summed kernel time per step and its share of the span
(how busy the card is), the count of top-level aten calls and of kernel
launches per step, and the ``--top`` aten ops by host self time and
kernels by device time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROMPT_AND_CACHE = {"gpt2-xl": (12, 64), "zamba2-7b": (128, 512),
                    "xlstm-1_3b": (128, 256),
                    "seamless-m4t-large-v2": (8, 512)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt2-xl",
                    choices=sorted(PROMPT_AND_CACHE))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import resolve
    from repro_torch.device import resolve_device
    from repro_torch.distributed import steps
    from repro_torch.models import causal_lm, encdec

    dev = resolve_device("cuda")
    cfg = resolve(args.arch).full
    n_prompt, cache_len = PROMPT_AND_CACHE[args.arch]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = encdec if cfg.family == "encdec" else causal_lm
    params = model.init(cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (args.batch, n_prompt),
                           generator=gen, device=dev)
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        frames = np.random.default_rng(0).standard_normal(
            (args.batch, steps.src_len_for(cfg, cache_len), cfg.d_frontend))
        batch["src_embeds"] = torch.from_numpy(
            frames.astype(np.float32)).to(dev)
    logits, cache = steps.make_prefill_step(cfg, cache_len)(params, batch)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    decode = steps.make_decode_step(cfg)

    def step():
        return decode(params, cache, tok)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    spans, hosts = [], []
    for _ in range(args.reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step()
        b.record()
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    top_level = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name.startswith("aten::")
                 and not (e.cpu_parent is not None
                          and e.cpu_parent.name.startswith("aten::"))]
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    avg = prof.key_averages()
    cpu_ops = sorted((e for e in avg if e.key.startswith("aten::")),
                     key=lambda e: -e.self_cpu_time_total)
    gpu = sorted((e for e in avg
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    kernel_ms = sum(e.self_device_time_total for e in gpu) / args.reps / 1e3
    span = statistics.median(spans)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "model": cfg.name,
        "batch": args.batch, "reps": args.reps,
        "span_ms_median": span, "span_ms": spans,
        "host_ms_median": statistics.median(hosts),
        "kernel_ms_per_step": kernel_ms, "busy_share": kernel_ms / span,
        "aten_calls_per_step": len(top_level) / args.reps,
        "kernel_launches_per_step": len(kernels) / args.reps,
        "top_host_ops": [
            {"op": e.key, "calls": e.count // args.reps,
             "self_cpu_ms": e.self_cpu_time_total / args.reps / 1e3}
            for e in cpu_ops[:args.top]],
        "top_kernels": [
            {"kernel": e.key[:80], "launches": e.count // args.reps,
             "device_ms": e.self_device_time_total / args.reps / 1e3}
            for e in gpu[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
