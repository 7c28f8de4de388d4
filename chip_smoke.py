#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the five Top-K kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc (into ``build/``);
3. holds each kernel bit-exact against its plain PyTorch version on the
   card: fp32/bf16/fp16, ragged sizes (tails that are not a multiple of
   the 16-byte vector), inputs at a storage offset (unaligned), all zeros,
   all equal, heavy ties, blocks of 1 + i ulp (one large candidate list),
   k = 1, B - 1 and B, the training path's boundary shapes (the
   error-feedback kernels with a residual drawn like x), and the decode of
   bitmaps with more than k bits set;
4. times each kernel with CUDA events, the profiler and the host clock
   (``*_host_us``: enqueue time a call) at the path's boundary shapes,
   beside its plain version, its memory bound and ``torch.topk``
   (selection only);
5. drives the port's training path — gpt2-xl at full width and depth,
   batch 8, seq 128, paper testbed 1, ``DecentralizedRuntime(use_kernel=
   "auto")`` — for a few AdamW steps under the uniform (ratio 100) and the
   AdaTopK plan, and under the uniform plan with error feedback (EF-SGD on
   the boundary gradients), with launch counters set to 0 just before each
   and read just after, and checks them against the plan's
   compressed-message count;
6. drives the gspmd path — ``train_gspmd``, the launcher's default mode:
   gpt2-xl at full width and depth as one model on the card, batch 8, seq
   128, fp32, 4 AdamW steps — with the launch counters set to 0 just
   before it and read just after (it runs no codec, so all stay 0); prints
   the step seconds, tokens/s and peak memory, times one more step in its
   parts (forward, backward, clip, update) with CUDA events, and runs 2
   Adafactor steps at the same size for their peak memory;
7. drives the elastic runtime — gpt2-xl at full width and depth,
   ``ElasticController`` under the joint planner (AdaTopK ratio 100) with
   ``use_kernel="auto"``, stop-the-world migration and AdamW — for 6 useful
   steps through one CompNode failure (a stage host of the probe's
   schedule, lease 1.5 probe iterations): rollback to a checkpoint,
   re-plan on the survivors and a bit-exact migration of parameters and
   AdamW state, with the launches of each step held against its plan's
   compressed messages; it prints each epoch, the migration's envelopes and
   wire bytes, the checkpoint blob's size and seconds per serialize and
   deserialize, the host's MemTotal, steady step seconds, and the card's
   allocation before and peak within each step, update, serialize, restore
   and migration;
8. drives the serving path — gpt2-xl at full width and depth, random
   weights from seed 0, fp32, served the way ``repro_torch.launch.serve
   --churn`` serves it: 3 stages over ``geo_random(8, seed=0)``, cache_len
   64, 4 slots a replica, the launcher's 6 Poisson requests at 200 req/s
   (prompts of 4-12 tokens, 16-32 new) — a leg with no churn (the failure
   derivation's dry run) and a leg that kills the replica it picks, the
   codec's counts set to 0 just before and read just after (all stay 0);
   it checks that every session completes, that the churn leg re-routes
   with a KV replay, that the tokens of the two legs are equal and equal a
   monolithic greedy loop (``causal_lm.prefill`` + ``decode_step``) on the
   card, with the staged chain's logits bit-identical to the monolithic
   model's at every step of the first request; it prints both legs' wall
   seconds and tokens/s, the simulated report, the peak memory, and the
   monolithic prefill (12 tokens) and decode step (batch 1 and 4) in ms
   (median of 20, CUDA events) beside the profiler's kernel time and the
   byte bound;
9. drives the error-feedback and dense entry points (``ef_compress``,
   ``ops.topk_mask``, ``ops.ef_topk``) over 5 steps with the residual
   carried, counting their launches, and holds ``ef_compress`` bit-exact
   against the EF training step's own composition on the card and against
   the CPU's plain version;
10. holds ``encode_topk`` and ``decode_topk`` bit-exact against their plain
   versions at every (boundary shape, k a block) that the training and
   elastic paths gave them, derived from each step's plan;
11. checks the output the repository's way: finite losses, RAD equal to
    single-device autograd on the card at smoke size, the card's loss
    curves (plain and error-feedback) against the CPU's on the same
    weights, gpt2-smoke through ``train_gspmd`` on the card against the
    CPU (losses within rel 1e-3), the elastic example's smoke
    configuration through a failure on the card and on the CPU (stop and
    overlap: identical epoch records and clock, losses within rel 1e-3;
    under the dense planner the run through the failure equals the run
    without it within rel 1e-6), the JAX serving benchmark's ``geo``
    profile at smoke size (llama3-8b smoke, 2 stages, 10 requests) through
    a failure on the card and on the CPU (equal tokens, exactly equal
    simulated reports), and the moe smoke model through 3 stages (staged
    equal to monolithic bit for bit on the card, logits within rel 1e-5 of
    the CPU's).

Every phase raises on failure (exit code 1).  Without a CUDA device, or
without ``src/repro_torch`` beside it, it exits with code 2 and prints no
result.  The last line of standard output is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS = 4                   # AdamW steps per plan on the training path
BATCH, SEQ = 8, 128         # the launcher's defaults
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/csrc/topk_codec.cu"
EF_STEPS = 5                # carried residual steps on the entry points
REPLACES = {"encode_topk": "src/repro/kernels/topk_compress.py:228",
            "ef_encode_topk": "src/repro/kernels/topk_compress.py:255",
            "decode_topk": "src/repro/kernels/topk_compress.py:279",
            "blockwise_topk_mask": "src/repro/kernels/topk_compress.py:108",
            "ef_topk": "src/repro/kernels/topk_compress.py:108"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events; inputs stay warm in L2, as a boundary tensor just written by
    its stage would be)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 300, warmup: int = 10) -> float:
    """Host time per call of ``fn`` in microseconds: ``perf_counter_ns``
    around ``reps`` enqueued calls, without waiting for the card (the
    synchronise after the loop is not timed)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.to(torch.float32).view(torch.int32),
                           b.to(torch.float32).view(torch.int32))
    return torch.equal(a, b)


def check_kernels(dev):
    """Every case bit-exact; returns the max |kernel - plain| per kernel.
    The residual of the error-feedback kernels is drawn like x.  Inputs are
    finite: ``c - sent`` (ef_topk) and ``kept ? 0 : c`` (ef_encode_topk)
    agree only there, and no regime here draws inf or NaN."""
    import torch
    from repro_torch.kernels import ref, topk_compress as tk

    gen = torch.Generator().manual_seed(0)
    levels = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])
    cases = [((64,), 1, 512, "normal"), ((5000,), 40, 512, "normal"),
             ((1000,), 5, 512, "zeros"), ((3000,), 9, 512, "ties"),
             ((9000,), 1, 4096, "ties"), ((9000,), 4096, 4096, "normal"),
             ((4097,), 4096, 4096, "zeros"), ((33, 1001), 17, 4096, "normal"),
             ((4103,), 41, 4096, "normal"), ((5003,), 17, 4096, "offset"),
             ((BATCH, SEQ, 1600), 41, 4096, "offset"),
             ((8192,), 41, 4096, "ulp"), ((4100,), 2000, 4096, "ulp"),
             ((1024,), 100, 512, "ulp")]
    cases += [((4096,), k, block, regime) for regime in ("equal", "zeros")
              for k, block in ((1, 4096), (4095, 4096), (4096, 4096),
                               (1, 512), (511, 512))]
    cases += [((BATCH, SEQ, 1600), 41, 4096, "normal"),
              ((BATCH, SEQ, 50432), 41, 4096, "normal")]

    def draw(n, regime, dtype):
        """A CPU tensor of n elements; "offset" is a view at storage offset
        1 (moved to the card by ``place``)."""
        if regime == "zeros":
            return torch.zeros(n)
        if regime == "ties":
            return levels[torch.randint(0, 5, (n,), generator=gen)]
        sign = torch.randint(0, 2, (n,), generator=gen) * 2.0 - 1.0
        if regime == "equal":
            return 0.75 * sign
        if regime == "ulp":
            # 1 + i ulp: the magnitudes share their top 11-20 bits, so the
            # whole block is one candidate list
            span = {torch.float32: 4096, torch.bfloat16: 16,
                    torch.float16: 128}[dtype]
            i = torch.randperm(n, generator=gen) % span
            return sign * (1 + i * torch.finfo(dtype).eps)
        return torch.randn(n + (regime == "offset"), generator=gen)

    def place(t, shape, regime, dtype):
        t = t.to(dtype).to(dev)
        return (t[1:] if regime == "offset" else t).reshape(shape)

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    err = {name: 0.0 for name in tk.KERNELS}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for shape, k, block, regime in cases:
            n = math.prod(shape)
            x = place(draw(n, regime, dtype), shape, regime, dtype)
            r = place(draw(n, regime, dtype), shape, regime, dtype)
            v, m = tk.encode_topk(x, k, block)
            d = tk.decode_topk(v, m, shape)
            ev, em, er = tk.ef_encode_topk(x, r, k, block)
            dm = tk.blockwise_topk_mask(x, k, block)
            ds, dr = tk.ef_topk(x, r, k, block)
            torch.cuda.synchronize()
            vr, mr = ref.encode_topk_ref(x, k, block)
            dref = ref.decode_topk_ref(vr, mr, shape)
            evr, emr, enr = ref.ef_encode_topk_ref(x, r, k, block)
            dmr = ref.blockwise_topk_mask_ref(x, k, block)
            dsr, drr = ref.ef_topk_ref(x, r, k, block)
            pairs = {"encode_topk": [(v, vr), (m, mr)],
                     "decode_topk": [(d, dref)],
                     "ef_encode_topk": [(ev, evr), (em, emr), (er, enr)],
                     "blockwise_topk_mask": [(dm, dmr)],
                     "ef_topk": [(ds, dsr), (dr, drr)]}
            for name, outs in pairs.items():
                if not all(bits_equal(a, b) for a, b in outs):
                    raise AssertionError(
                        f"{name} != plain version: {dtype} {shape} k={k} "
                        f"block={block} {regime}")
                err[name] = max([err[name]] + [diff(a, b) for a, b in outs
                                                if a.is_floating_point()])
            n_cases += 1
        # decode of bitmaps with more than k bits set: slots past k - 1
        # read the last value, as the plain version clamps them
        for n, k, block in ((5000, 40, 512), (9000, 41, 4096)):
            nb = -(-n // block)
            v = torch.randn(nb, k, generator=gen).to(dtype).to(dev)
            m = torch.randint(-2 ** 31, 2 ** 31, (nb, block // 32),
                              generator=gen, dtype=torch.int32).to(dev)
            d = tk.decode_topk(v, m, (n,))
            torch.cuda.synchronize()
            if not bits_equal(d, ref.decode_topk_ref(v, m, (n,))):
                raise AssertionError(f"decode_topk != plain version on a "
                                     f"bitmap with more than k bits set: "
                                     f"{dtype} n={n} k={k} block={block}")
            n_cases += 1
    print(f"kernel checks: {n_cases} cases bit-exact against the plain "
          f"versions (fp32/bf16/fp16; ragged, storage offset, zeros, ties, "
          f"all-equal, 1 + i ulp, k = 1, B - 1 and B, boundary shapes; "
          f"decode of over-full bitmaps)")
    return err


def measure_kernels(dev):
    """Times at the training path's boundary shapes (fp32, ratio 100)."""
    import torch
    from repro_torch.kernels import ops, ref, topk_compress as tk

    out = {}
    for shape in ((BATCH, SEQ, 1600), (BATCH, SEQ, 50432)):
        n = math.prod(shape)
        block = tk.DEFAULT_BLOCK
        nb = -(-n // block)
        k = ops.per_block_k(n, -(-n // 100), block)
        x = torch.randn(shape, device=dev)
        r = torch.randn(shape, device=dev)
        v, m = tk.encode_topk(x, k, block)
        item = x.element_size()
        dense = n * item                         # one tensor of x's shape
        wire = nb * k * item + nb * (block // 32) * 4
        # least time: each input read once and each output written once
        # over HBM, or one magnitude compare (and one add or subtract with
        # error feedback) per element at the fp32 rate — bytes win by far
        work = {"encode": (dense + wire, n), "decode": (wire + dense, n),
                "ef_encode": (3 * dense + wire, 2 * n),
                "blockwise_topk_mask": (2 * dense, n),
                "ef_topk": (4 * dense, 3 * n)}
        calls = {
            "encode": (lambda: tk.encode_topk(x, k, block),
                       lambda: ref.encode_topk_ref(x, k, block)),
            "decode": (lambda: tk.decode_topk(v, m, shape),
                       lambda: ref.decode_topk_ref(v, m, shape)),
            "ef_encode": (lambda: tk.ef_encode_topk(x, r, k, block),
                          lambda: ref.ef_encode_topk_ref(x, r, k, block)),
            "blockwise_topk_mask": (
                lambda: tk.blockwise_topk_mask(x, k, block),
                lambda: ref.blockwise_topk_mask_ref(x, k, block)),
            "ef_topk": (lambda: tk.ef_topk(x, r, k, block),
                        lambda: ref.ef_topk_ref(x, r, k, block))}
        row = {"shape": list(shape), "k_per_block": k, "blocks": nb,
               "topk_selection_only_ms": time_ms(
                   lambda: torch.topk(x.reshape(nb, block).abs(), k, dim=1))}
        for short, (kernel, plain) in calls.items():
            nbytes, ops_ = work[short]
            row[f"{short}_ms"] = time_ms(kernel)
            row[f"{short}_host_us"] = host_us(kernel)
            row[f"{short}_plain_ms"] = time_ms(plain, reps=10)
            row[f"{short}_bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                                 ops_ / FP32_OPS_PER_S)
        row.update(kernel_device_us(
            lambda: tk.decode_topk(*tk.encode_topk(x, k, block), shape),
            {"encode_device_us": "encode_kernel",
             "decode_device_us": "decode_kernel"}))
        row.update(kernel_device_us(
            lambda: tk.ef_encode_topk(x, r, k, block),
            {"ef_encode_device_us": "encode_kernel"}))
        row.update(kernel_device_us(
            lambda: tk.blockwise_topk_mask(x, k, block),
            {"blockwise_topk_mask_device_us": "dense_kernel"}))
        row.update(kernel_device_us(
            lambda: tk.ef_topk(x, r, k, block),
            {"ef_topk_device_us": "dense_kernel"}))
        out[tuple(shape)] = row
        print("timing " + json.dumps(row))
        del x, r, v, m
        torch.cuda.empty_cache()
    return out


def kernel_device_us(fn, patterns, reps: int = 20) -> dict:
    """Device time per launch of the kernels whose names hold each pattern
    (``{label: pattern}``), from the profiler's CUDA activity (``None``
    where the profiler saw no device time).  The event times above also
    hold the gaps while the host prepares the next launch; these do not.
    ``fn`` launches one kernel per pattern."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = {label: None for label in patterns}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0)
        for label, pattern in patterns.items():
            if pattern in ev.key and total and ev.count:
                found[label] = total / ev.count
    return found


def compressed_messages(prog, plan) -> int:
    """Cross-stage messages with ratio > 1 in one direction of one
    micro-batch — what RAD compresses (rad.pipeline_forward)."""
    n = 0
    for sd in prog.subdags:
        for a in sd.required_acti:
            users = [c for c in sd.node_names if a in prog.graph.nodes[c].args]
            if max([plan.ratio(a, c) for c in users] or [1.0]) > 1.0:
                n += 1
    return n


def codec_cases(prog, plan, input_shapes) -> set:
    """(boundary shape, k a block) of each compressed message of ``plan``
    at ``input_shapes`` — what ``compress_for_edge`` gives the codec
    (rad.pipeline_forward: the largest ratio over the message's users, k
    from ``ratio_to_k``, then ``ops.per_block_k``); the gradient goes
    through the codec at the same shape and k."""
    from repro_torch.core.compression import ratio_to_k
    from repro_torch.kernels import ops
    shapes = prog.graph.infer_shapes(input_shapes)
    cases = set()
    for sd in prog.subdags:
        for a in sd.required_acti:
            users = [c for c in sd.node_names if a in prog.graph.nodes[c].args]
            ratio = max([plan.ratio(a, c) for c in users] or [1.0])
            if ratio > 1.0:
                n = math.prod(shapes[a])
                cases.add((tuple(shapes[a]),
                           ops.per_block_k(n, ratio_to_k(n, ratio))))
    return cases


def check_path_cases(dev, cases) -> dict:
    """``encode_topk`` and ``decode_topk`` at every (shape, k a block) the
    driven paths gave them, fp32 as on the paths and bf16 / fp16, bit-exact
    against the plain versions; returns the max |kernel - plain| of each.
    Its launches come after the paths' counts were read."""
    import torch
    from repro_torch.kernels import ref, topk_compress as tk

    gen = torch.Generator().manual_seed(5)
    block = tk.DEFAULT_BLOCK
    err = {"encode_topk": 0.0, "decode_topk": 0.0}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for shape, k in sorted(cases):
            x = torch.randn(shape, generator=gen).to(dtype).to(dev)
            v, m = tk.encode_topk(x, k, block)
            d = tk.decode_topk(v, m, shape)
            torch.cuda.synchronize()
            vr, mr = ref.encode_topk_ref(x, k, block)
            dr = ref.decode_topk_ref(vr, mr, shape)
            for name, outs in (("encode_topk", [(v, vr), (m, mr)]),
                               ("decode_topk", [(d, dr)])):
                if not all(bits_equal(a, b) for a, b in outs):
                    raise AssertionError(f"{name} != plain version at a "
                                         f"path's shape: {dtype} {shape} "
                                         f"k={k}")
                err[name] = max([err[name]] + [
                    float((a.float() - b.float()).abs().max())
                    for a, b in outs if a.is_floating_point()])
    print(f"path shapes: encode_topk and decode_topk bit-exact against the "
          f"plain versions at every compressed boundary the paths ran "
          f"(fp32/bf16/fp16): " + json.dumps(sorted(
              [list(shape), k] for shape, k in cases)))
    return err


def launch_counts() -> dict:
    from repro_torch.kernels import topk_compress as tk
    return {n: f.launches for n, f in tk.KERNELS.items()}


def run_training_path(dev):
    """gpt2-xl full under the uniform and AdaTopK plans, and under the
    uniform plan with error feedback; launch counts per run."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.launch.train import train_fusion
    from repro_torch.obs import slog

    cfg = resolve("gpt2-xl").full
    log = slog.get_logger("chip_smoke")
    results = {}
    for compress, ef in (("uniform", False), ("adatopk", False),
                         ("uniform", True)):
        label = f"{compress}+ef" if ef else compress
        tk.reset_launch_counts()        # this path's counts start here
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = train_fusion(cfg, batch=BATCH, seq=SEQ, steps=STEPS, lr=3e-4,
                           compress=compress, ratio=100.0, testbed=1,
                           device=dev, use_kernel="auto", data_order=1,
                           error_feedback=ef, log=log, log_every=1)
        wall = time.perf_counter() - t0
        got = launch_counts()
        msgs = compressed_messages(run.runtime.prog, run.plan)
        # one encode->decode per compressed message in each direction, 1
        # micro-batch: the forward activation through boundary_compress,
        # the gradient through boundary_compress or, with error feedback,
        # through topk_mask(g + r) (the forward's boundary input is
        # detached, so its own backward never runs a codec)
        expect = {n: msgs * 2 * 1 * STEPS if n in ("encode_topk",
                                                   "decode_topk") else 0
                  for n in tk.KERNELS}
        if not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"{label}: non-finite loss {run.losses}")
        if got != expect or msgs == 0:
            raise AssertionError(f"{label}: launches {got}, expected "
                                 f"{expect} ({msgs} messages)")
        results[label] = {
            "stages": len(run.schedule.stage_devices()),
            "compressed_edges": msgs,
            "codec_cases": sorted(
                [list(shape), k] for shape, k in codec_cases(
                    run.runtime.prog, run.plan,
                    {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ)})),
            "ratios": sorted(set(run.plan.edge_ratio.values())),
            "losses": run.losses, "step_s": run.step_seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": got, "wall_s": wall,
            "sim_iteration_s": run.sim.iteration_time}
        if ef:
            held = nonzero_residuals(run.runtime.ef_state)
            if held != msgs:
                raise AssertionError(f"{label}: {held} non-zero residuals, "
                                     f"expected one per compressed gradient "
                                     f"edge ({msgs})")
            results[label]["nonzero_residuals"] = held
        print(f"training path {label}: " + json.dumps(results[label]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return results


GSPMD_STEPS = 4             # AdamW steps of the gspmd path (the launcher's)
ADAFACTOR_STEPS = 2         # Adafactor steps at the same size
GSPMD_SMOKE_STEPS = 3       # gpt2-smoke, card against CPU


def time_step_phases(cfg, params, opt_state, opt, batch, dev) -> dict:
    """One more training step from (params, opt_state) with CUDA events
    between its parts: the forward (``train_loss``), the backward, the
    global-norm clip and the optimizer's update — the parts of
    ``make_train_step``, in its order.  Milliseconds each."""
    import torch
    from repro_torch.core.rad import tree_map
    from repro_torch.models import causal_lm
    from repro_torch.optim import clip_by_global_norm

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    torch.cuda.synchronize(dev)
    ev[0].record()
    loss, _ = causal_lm.train_loss(cfg, leaves, batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    loss = loss.detach()                # the graph holds the leaves
    grads, _ = clip_by_global_norm(tree_map(lambda p: p.grad, leaves), 1.0)
    del leaves                          # the unclipped gradients go here
    ev[3].record()
    new = opt.update(grads, opt_state, params)
    ev[4].record()
    torch.cuda.synchronize(dev)
    del new, grads
    parts = ("forward", "backward", "clip", "update")
    out = {f"{name}_ms": ev[i].elapsed_time(ev[i + 1])
           for i, name in enumerate(parts)}
    out["step_ms"] = ev[0].elapsed_time(ev[4])
    out["loss"] = float(loss)
    return out


def run_gspmd_path(dev):
    """gpt2-xl full through ``train_gspmd`` (the launcher's default mode):
    the whole model on the card, AdamW, GSPMD_STEPS steps, launch counts
    from just before the run to just after (this path runs no codec); then
    one step timed in parts, and ADAFACTOR_STEPS Adafactor steps."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.launch.train import train_gspmd
    from repro_torch.obs import slog
    from repro_torch.optim import adafactor, adamw, linear_warmup_cosine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = resolve("gpt2-xl").full
    log = slog.get_logger("chip_smoke")
    opt = adamw(linear_warmup_cosine(3e-4, 10, GSPMD_STEPS),
                weight_decay=0.0)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)
    tk.reset_launch_counts()            # this path's counts start here
    t0 = time.perf_counter()
    run = train_gspmd(cfg, batch=BATCH, seq=SEQ, steps=GSPMD_STEPS, lr=3e-4,
                      device=dev, optimizer=opt, data_order=1, log=log,
                      log_every=1)
    wall = time.perf_counter() - t0
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in run.losses):
        raise AssertionError(f"gspmd: non-finite loss {run.losses}")
    if any(got.values()):
        raise AssertionError(f"gspmd: the codec ran on a path without "
                             f"compression: {got}")
    steady = run.step_seconds[1:]
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0, order=1)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in ds.batch(BATCH, GSPMD_STEPS).items()}
    torch.cuda.reset_peak_memory_stats(dev)
    phases = time_step_phases(cfg.replace(max_seq=max(cfg.max_seq, SEQ)),
                              run.params, run.opt_state, opt, batch, dev)
    phases["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if not math.isfinite(phases["loss"]):
        raise AssertionError(f"gspmd: non-finite timed step {phases}")
    report = {
        "params": sum(t.numel() for t in tree_leaves(run.params)),
        "losses": run.losses, "grad_norms": [m["grad_norm"]
                                             for m in run.metrics],
        "step_s": run.step_seconds, "first_step_s": run.step_seconds[0],
        "steady_step_s": steady,
        "tokens_per_s": BATCH * SEQ * len(steady) / sum(steady),
        "allocated_before_gb": allocated / 1e9, "peak_mem_gb": peak / 1e9,
        "wall_s": wall, "launches": got, "timed_step": phases}
    print("gspmd path: " + json.dumps(report))
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    run = train_gspmd(cfg, batch=BATCH, seq=SEQ, steps=ADAFACTOR_STEPS,
                      device=dev, optimizer=adafactor(1e-3), data_order=1,
                      log=log, log_every=1)
    if not all(math.isfinite(x) for x in run.losses):
        raise AssertionError(f"gspmd adafactor: non-finite loss "
                             f"{run.losses}")
    print("gspmd adafactor: " + json.dumps({
        "losses": run.losses, "step_s": run.step_seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return got


def check_gspmd_smoke(dev):
    """gpt2-smoke through ``train_gspmd`` on the card and on the CPU from
    the same weights and data: losses within rel 1e-3."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.launch.train import train_gspmd
    from repro_torch.models import causal_lm

    cfg = resolve("gpt2-xl").smoke
    params = causal_lm.init(cfg, torch.Generator().manual_seed(1))
    curves = {side: train_gspmd(cfg, batch=8, seq=32,
                                steps=GSPMD_SMOKE_STEPS, device=d,
                                params=params, data_order=1,
                                log_every=100).losses
              for side, d in (("card", dev), ("cpu", torch.device("cpu")))}
    gap = max(abs(x - y) / abs(y) for x, y in zip(curves["card"],
                                                  curves["cpu"]))
    if gap > 1e-3 or not all(math.isfinite(x) for x in curves["card"]):
        raise AssertionError(f"gspmd: card and CPU loss curves differ: "
                             f"{curves}")
    print(f"gspmd smoke check: card {curves['card']} vs cpu "
          f"{curves['cpu']} (max rel {gap:.3e})")


def nonzero_residuals(ef_state) -> int:
    return sum(int(bool((r != 0).any())) for r in ef_state.values())


def run_entry_points(dev):
    """The error-feedback codec and the dense masks through their entry
    points at the block-output boundary, fp32, ratio 100, over EF_STEPS
    steps with the residuals carried.  Each step holds ``ef_compress`` on
    the card (kernels 4 and 5) bit-exact against the EF training step's own
    composition on the card (``c = x + r``, the codec ``topk_mask``,
    ``c - sent``: kernels 3 and 5) and against the CPU's plain
    ``ef_compress``, and ``ops.topk_mask`` / ``ops.ef_topk`` (kernels 1 and
    2) against the CPU's plain versions.  Returns the entry points'
    launches; the comparisons' launches are not counted."""
    import torch
    from repro_torch.core.compression import (ErrorFeedbackState,
                                              ef_compress, ratio_to_k,
                                              topk_mask)
    from repro_torch.kernels import ops, topk_compress as tk

    shape = (BATCH, SEQ, 1600)
    n = math.prod(shape)
    k = ratio_to_k(n, 100.0)
    kpb = ops.per_block_k(n, k)
    gen = torch.Generator(device=dev).manual_seed(3)
    st = ErrorFeedbackState.init(torch.zeros(shape, device=dev))
    st_cpu = ErrorFeedbackState.init(torch.zeros(shape))
    r_comp = torch.zeros(shape, device=dev)
    r_dense, r_dense_cpu = torch.zeros(shape, device=dev), torch.zeros(shape)
    tk.reset_launch_counts()            # this path's counts start here
    launches = dict.fromkeys(tk.KERNELS, 0)

    def counted(fn):
        before = launch_counts()
        out = fn()
        for name, c in launch_counts().items():
            launches[name] += c - before[name]
        return out

    def same(what, step, *ts):
        cpu = [t.cpu() for t in ts]
        if not all(bits_equal(cpu[0], t) for t in cpu[1:]):
            raise AssertionError(f"entry points, step {step}: {what} differ")

    for step in range(EF_STEPS):
        x = torch.randn(shape, generator=gen, device=dev)
        xc = x.cpu()
        sent, st = counted(lambda: ef_compress(x, st, k, "auto"))
        c = x + r_comp                  # rad.pipeline_loss_and_grad_ef
        sent_c = topk_mask(c, k, use_kernel="auto")
        r_comp = c - sent_c
        sent_p, st_cpu = ef_compress(xc, st_cpu, k, "auto")
        same("ef_compress sent (card, composition, CPU)", step,
             sent, sent_c, sent_p)
        same("ef_compress residual (card, composition, CPU)", step,
             st.residual, r_comp, st_cpu.residual)
        same("ops.topk_mask (card, CPU)", step,
             counted(lambda: ops.topk_mask(x, k)), ops.topk_mask(xc, k))
        sd, r_dense = counted(lambda: ops.ef_topk(x, r_dense, kpb))
        sd_p, r_dense_cpu = ops.ef_topk(xc, r_dense_cpu, kpb)
        same("ops.ef_topk sent (card, CPU)", step, sd, sd_p)
        same("ops.ef_topk residual (card, CPU)", step, r_dense, r_dense_cpu)
    expect = {"encode_topk": 0, "ef_encode_topk": EF_STEPS,
              "decode_topk": EF_STEPS, "blockwise_topk_mask": EF_STEPS,
              "ef_topk": EF_STEPS}
    if launches != expect:
        raise AssertionError(f"entry points: launches {launches}, expected "
                             f"{expect}")
    print(f"entry points: {EF_STEPS} carried steps at {list(shape)} k={k} "
          f"({kpb} a block): ef_compress == EF-step composition == CPU, "
          f"ops.topk_mask and ops.ef_topk == CPU, bit for bit; launches "
          + json.dumps(launches))
    return launches


ELASTIC_STEPS = 6           # useful AdamW steps through the failure
ELASTIC_FAIL_AT = 0.4       # failure time as a fraction of the run (example)
SMOKE_ELASTIC_STEPS = 12    # the smoke-size cross-check's run


def mem_total() -> str:
    with open("/proc/meminfo") as f:
        return next(line.split(":", 1)[1].strip() for line in f
                    if line.startswith("MemTotal:"))


def probe_failure(graph, prof, cluster, dev, planner, ratio, steps):
    """The elastic example's trace: a timing-only probe gives the iteration
    time; its third stage host fails at ELASTIC_FAIL_AT of the run."""
    from repro_torch.elastic import (ChurnTrace, ElasticController,
                                     single_failure_trace)
    probe = ElasticController(graph, prof, cluster, ChurnTrace(()),
                              n_micro=2, planner=planner, joint_ratio=ratio,
                              use_kernel="auto", device=dev)
    t1 = probe.run(steps=1).steps[0].step_seconds
    victim = probe.schedule.stage_devices()[2]
    return t1, victim, single_failure_trace(victim,
                                            at=ELASTIC_FAIL_AT * steps * t1)


def micro_batches(ds, batch):
    """``data_fn`` of the elastic runs: step -> two micro-batches."""
    def data_fn(step):
        b = ds.batch(batch, step)
        mb = batch // 2
        return [{k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
                for i in range(2)]
    return data_fn


class ElasticMeter:
    """Measures the controller's own calls while it runs, and changes none
    of their results.  Every serialize, restore, migration, training step
    and AdamW update is one phase with its start and end on the host's
    clock, the card synced at both: its seconds, the bytes allocated on the
    card before and after it and its peak allocation (the peak restarts at
    each phase's start).  Blob bytes, each migration's envelopes and wire
    bytes, and each training step's codec launches beside the plan's
    compressed messages and codec shapes are recorded too.  It wraps the
    names ``controller`` calls (``serialize_state``, ``deserialize_state``,
    ``apply_moves``), ``DecentralizedRuntime.train_step`` and the
    optimizer's update; ``check_calls`` fails the run when one of them was
    not reached as often as the run's records say it was called."""

    def __init__(self, dev):
        self.dev = dev
        self.serialize, self.deserialize, self.moves, self.steps = \
            [], [], [], []
        self.cases = set()
        self.peak = 0

    def _start(self):
        import torch
        torch.cuda.synchronize(self.dev)
        self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))
        torch.cuda.reset_peak_memory_stats(self.dev)
        return time.perf_counter(), torch.cuda.memory_allocated(self.dev)

    def _end(self, start) -> dict:
        import torch
        torch.cuda.synchronize(self.dev)
        t0, live = start
        return {"seconds": time.perf_counter() - t0,
                "allocated_before_gb": live / 1e9,
                "allocated_after_gb": torch.cuda.memory_allocated(self.dev)
                / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated(self.dev) / 1e9}

    def optimizer(self, opt):
        from repro_torch.optim.optimizers import Optimizer

        def update(grads, state, params):
            start = self._start()
            out = opt.update(grads, state, params)
            self.steps[-1]["update"] = self._end(start)
            return out
        return Optimizer(init=opt.init, update=update)

    def __enter__(self):
        import repro_torch.elastic.controller as ctl
        from repro_torch.core.executor import DecentralizedRuntime

        self._saved = (ctl.serialize_state, ctl.deserialize_state,
                       ctl.apply_moves, DecentralizedRuntime.train_step)
        ser, deser, apply, step = self._saved

        def serialize_state(params, opt_state=None):
            start = self._start()
            blob = ser(params, opt_state)
            self.serialize.append({**self._end(start), "bytes": len(blob)})
            return blob

        def deserialize_state(blob, params, opt_state=None):
            start = self._start()
            out = deser(blob, params, opt_state)
            self.deserialize.append({**self._end(start), "bytes": len(blob)})
            return out

        def apply_moves(params, opt_state, moves, trace=None):
            start = self._start()
            out = apply(params, opt_state, moves, trace)
            self.moves.append({**self._end(start), "ops": len(moves),
                               "envelopes": out.n_envelopes,
                               "wire_bytes": out.wire_bytes})
            return out

        def train_step(rt, params, mbs):
            before = launch_counts()
            start = self._start()
            out = step(rt, params, mbs)
            phase = self._end(start)
            after = launch_counts()
            self.cases |= codec_cases(rt.prog, rt.plan, {
                k: tuple(v.shape) for k, v in mbs[0].items()})
            self.steps.append({
                "train": phase,
                "launches": {n: after[n] - before[n] for n in after},
                "messages": compressed_messages(rt.prog, rt.plan) * 2
                * len(mbs)})
            return out

        ctl.serialize_state, ctl.deserialize_state = (serialize_state,
                                                      deserialize_state)
        ctl.apply_moves = apply_moves
        DecentralizedRuntime.train_step = train_step
        return self

    def __exit__(self, *exc):
        import torch
        import repro_torch.elastic.controller as ctl
        from repro_torch.core.executor import DecentralizedRuntime
        (ctl.serialize_state, ctl.deserialize_state, ctl.apply_moves,
         DecentralizedRuntime.train_step) = self._saved
        self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))
        return False

    def check_calls(self, res, interval: int) -> None:
        """One training step and one update for each step record, one
        serialize at step 0 and one at each executed step that is a
        multiple of ``interval``, one restore for each rollback, and at
        least one migration, each with envelopes."""
        rollbacks = sum(1 for e in res.epochs if e.rollback_steps)
        serializes = 1 + sum(1 for r in res.steps if r.step % interval == 0)
        if len(self.steps) != len(res.steps) \
                or not all("update" in st for st in self.steps) \
                or len(self.serialize) != serializes \
                or len(self.deserialize) != rollbacks \
                or not self.moves \
                or not all(m["envelopes"] for m in self.moves):
            raise AssertionError(
                f"elastic: measured {len(self.steps)} train steps "
                f"({sum('update' in st for st in self.steps)} updates), "
                f"{len(self.serialize)} serializes, {len(self.deserialize)} "
                f"restores, migrations {self.moves}; the records say "
                f"{len(res.steps)} steps, {serializes} serializes, "
                f"{rollbacks} rollbacks")


def run_elastic_path(dev):
    """gpt2-xl full through one CompNode failure: ``ElasticController``
    (joint planner, AdaTopK ratio 100, stop-the-world migration, AdamW,
    checkpoints every 3 steps with 2 kept) for ELASTIC_STEPS useful steps,
    the kernels' launches counted from just before the run to just after.
    Returns the path's launch counts and the (shape, k a block) of every
    compressed boundary it ran."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core import network
    from repro_torch.data import SyntheticLM
    from repro_torch.elastic import ElasticController
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.models.opgraph_models import gpt_opgraph
    from repro_torch.optim import adamw

    print(f"elastic: host MemTotal {mem_total()}")
    cfg = resolve("gpt2-xl").full
    graph = gpt_opgraph(cfg, BATCH, SEQ)
    shapes = {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ)}
    prof = graph.annotate(shapes)
    cluster = network.paper_testbed(1, seed=0)
    t1, victim, trace = probe_failure(graph, prof, cluster, dev, "joint",
                                      100.0, ELASTIC_STEPS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the list hands the controller the only reference to the initial
    # weights, which it drops at the first update
    params = [graph.init(gen, shapes)]
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0, order=1)
    meter = ElasticMeter(dev)
    ctrl = ElasticController(
        graph, prof, cluster, trace, optimizer=meter.optimizer(adamw(3e-4)),
        n_micro=2, lease_s=1.5 * t1, migration_mode="stop",
        planner="joint", joint_ratio=100.0, use_kernel="auto",
        checkpoint_interval=3, checkpoint_history=2, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)
    tk.reset_launch_counts()            # this path's counts start here
    t0 = time.perf_counter()
    with meter:
        res = ctrl.run(steps=ELASTIC_STEPS,
                       data_fn=micro_batches(ds, BATCH), params=params.pop())
    wall = time.perf_counter() - t0
    got = launch_counts()

    meter.check_calls(res, interval=3)
    losses = [r.loss for r in res.steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"elastic: non-finite loss {losses}")
    if res.useful_steps != ELASTIC_STEPS:
        raise AssertionError(f"elastic: {res.useful_steps} useful steps")
    fail = [e for e in res.epochs if e.cause == "failure"]
    if len(fail) != 1 or not fail[0].rollback_steps or not fail[0].n_moves:
        raise AssertionError(f"elastic: expected one failure epoch with a "
                             f"rollback and moves: {res.epochs}")
    by_epoch = {}
    for rec, st in zip(res.steps, meter.steps):
        expect = {n: st["messages"] if n in ("encode_topk", "decode_topk")
                  else 0 for n in tk.KERNELS}
        if st["launches"] != expect:
            raise AssertionError(f"elastic: step {rec.step} of epoch "
                                 f"{rec.epoch}: launches {st['launches']}, "
                                 f"expected {expect}")
        e = by_epoch.setdefault(rec.epoch, {"steps": 0, "encode_topk": 0,
                                            "decode_topk": 0})
        e["steps"] += 1
        e["encode_topk"] += st["launches"]["encode_topk"]
        e["decode_topk"] += st["launches"]["decode_topk"]
    total = {n: sum(st["launches"][n] for st in meter.steps)
             for n in tk.KERNELS}
    if got != total or not total["encode_topk"]:
        raise AssertionError(f"elastic: launches {got} vs per step {total}")
    for e in res.epochs:
        print("elastic epoch " + json.dumps({
            "epoch": e.epoch, "cause": e.cause, "at_step": e.at_step,
            "replan_mode": e.replan_mode, "stages": len(e.stage_devices),
            "moves": e.n_moves, "moved_mb": e.moved_bytes / 1e6,
            "rollback_steps": e.rollback_steps,
            "detect_s": e.detect_seconds, "migrate_s": e.migrate_seconds,
            "refill_s": e.refill_seconds, "clock_s": e.clock,
            "launches": by_epoch.get(e.epoch)}))
    step_s = [st["train"]["seconds"] + st["update"]["seconds"]
              for st in meter.steps]
    steady = [t for r, t in zip(res.steps, step_s)
              if not r.lost and r.step > 1]
    # per executed step: GB allocated before it, peak in the training step,
    # peak in the update, allocated after the update
    memory = [(r.step, r.epoch, r.lost, st["train"]["allocated_before_gb"],
               st["train"]["peak_gb"], st["update"]["peak_gb"],
               st["update"]["allocated_after_gb"])
              for r, st in zip(res.steps, meter.steps)]
    report = {
        "victim": victim, "probe_iteration_s": t1,
        "steps_run": len(res.steps),
        "lost_steps": sum(r.lost for r in res.steps),
        "losses": [(r.step, r.loss, r.lost) for r in res.steps],
        "step_s": step_s, "steady_step_s": steady,
        "step_memory_gb": memory, "migrations": meter.moves,
        "serialize": meter.serialize, "deserialize": meter.deserialize,
        "allocated_at_start_gb": allocated / 1e9,
        "peak_mem_gb": meter.peak / 1e9, "wall_s": wall,
        "sim_total_s": res.total_seconds, "launches": got}
    print("elastic path: " + json.dumps(report))
    del res, ctrl
    gc.collect()
    torch.cuda.empty_cache()
    return got, meter.cases


def check_elastic_smoke(dev):
    """The elastic example's smoke configuration (6 layers, d_model 64,
    batch 8, seq 32, joint planner at AdaTopK ratio 8) through one failure,
    on the card and on the CPU from the same weights, in stop and overlap
    mode: the epoch and step records and the simulated clock must be
    identical, the losses within rel 1e-3.  Under the dense planner the
    card's run through the failure must give the losses of a run with no
    failure, step for step, within rel 1e-6."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ModelCfg
    from repro_torch.core import network
    from repro_torch.core.rad import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.elastic import ChurnTrace, ElasticController
    from repro_torch.models.opgraph_models import gpt_opgraph
    from repro_torch.optim import adamw

    batch, seq, steps = 8, 32, SMOKE_ELASTIC_STEPS
    cfg = ModelCfg(name="gpt-elastic-demo", family="dense", n_layers=6,
                   d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                   rope_fraction=0.0, max_seq=seq, norm="layernorm",
                   act="gelu")
    graph = gpt_opgraph(cfg, batch, seq)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    prof = graph.annotate(shapes)
    cluster = network.paper_testbed(1, seed=0)
    params_cpu = graph.init(torch.Generator().manual_seed(0), shapes)
    data_fn = micro_batches(SyntheticLM(vocab=cfg.vocab, seq_len=seq,
                                        seed=0, order=1), batch)

    def run(d, mode, planner, fail=True):
        t1, _, trace = probe_failure(graph, prof, cluster, d, planner, 8.0,
                                     steps)
        ctrl = ElasticController(
            graph, prof, cluster, trace if fail else ChurnTrace(()),
            optimizer=adamw(lr=3e-3), n_micro=2, lease_s=1.5 * t1,
            migration_mode=mode, planner=planner, joint_ratio=8.0,
            use_kernel="auto", device=d)
        return ctrl.run(steps=steps, data_fn=data_fn,
                        params=tree_map(lambda t: t.to(d), params_cpu))

    def records(res):
        steps_ = [dataclasses.asdict(r) for r in res.steps]
        for r in steps_:
            r.pop("loss")
        return ([dataclasses.asdict(e) for e in res.epochs], steps_,
                res.total_seconds)

    report = {}
    for mode in ("stop", "overlap"):
        card = run(dev, mode, "joint")
        cpu = run(torch.device("cpu"), mode, "joint")
        if records(card) != records(cpu):
            raise AssertionError(f"elastic smoke {mode}: card and CPU epoch "
                                 f"or step records differ")
        if not any(e.cause == "failure" for e in card.epochs):
            raise AssertionError(f"elastic smoke {mode}: no failure epoch")
        gap = max(abs(a.loss - b.loss) / abs(b.loss)
                  for a, b in zip(card.steps, cpu.steps))
        if gap > 1e-3:
            raise AssertionError(f"elastic smoke {mode}: card and CPU losses "
                                 f"differ by rel {gap}")
        report[mode] = {"epochs": [(e.cause, e.replan_mode, e.n_moves,
                                    e.rollback_steps) for e in card.epochs],
                        "clock_s": card.total_seconds,
                        "max_rel_loss_gap_card_cpu": gap}
    failed = dict(run(dev, "stop", "opfence").losses)
    clean = dict(run(dev, "stop", "opfence", fail=False).losses)
    if set(failed) != set(clean):
        raise AssertionError("elastic smoke opfence: steps differ")
    gap = max(abs(failed[s] - clean[s]) / abs(clean[s]) for s in clean)
    if gap > 1e-6:
        raise AssertionError(f"elastic smoke opfence: the run through the "
                             f"failure differs from the run without it by "
                             f"rel {gap}")
    report["opfence_max_rel_gap_failure_vs_none"] = gap
    print("elastic smoke checks: " + json.dumps(report))


def check_against_reference(dev):
    """Small-size checks by the repository's own contracts, on the card:
    RAD without compression equals single-device autograd, and a few
    compressed AdamW steps through the CUDA kernels follow the CPU's plain
    codec on the same weights and data, without and with error feedback
    (which after step 1 holds one non-zero residual per compressed
    gradient edge)."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core import (DecentralizedRuntime, PipelineProgram,
                                  network, pipeline_loss_and_grad,
                                  plan_uniform, schedule_opfence,
                                  single_device_loss_and_grad)
    from repro_torch.core.rad import tree_map
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.models.opgraph_models import gpt_opgraph
    from repro_torch.optim import adamw

    cfg = resolve("gpt2-xl").smoke
    b, s = 4, 32
    graph = gpt_opgraph(cfg, b, s)
    shapes = {"tokens": (b, s), "labels": (b, s)}
    sch = schedule_opfence(graph, graph.annotate(shapes),
                           network.paper_testbed(1, seed=0))
    params_cpu = graph.init(torch.Generator().manual_seed(1), shapes)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=s, seed=0, order=1)

    prog = PipelineProgram.build(graph, sch.pipeline_subdags(graph))
    params = tree_map(lambda t: t.to(dev), params_cpu)
    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in ds.batch(b, 0).items()}
    loss_p, grads_p = pipeline_loss_and_grad(prog, params, inputs)
    loss_s, grads_s = single_device_loss_and_grad(graph, params, inputs)
    worst = max(tree_leaves(tree_map(
        lambda a, b_: float((a - b_).abs().max() / (b_.abs().max() + 1e-30)),
        grads_s, grads_p)))
    if abs(float(loss_p) - float(loss_s)) > 1e-5 * abs(float(loss_s)) \
            or worst > 1e-5:
        raise AssertionError(f"RAD != single-device on the card: "
                             f"{float(loss_p)} vs {float(loss_s)}, {worst}")

    report = [f"RAD == single-device on the card (max rel grad diff "
              f"{worst:.3e})"]
    for ef in (False, True):
        plan = plan_uniform(graph, sch.placement, 10.0, error_feedback=ef)
        curves = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            rt = DecentralizedRuntime(graph, sch, plan, use_kernel="auto",
                                      device=d)
            p = tree_map(lambda t: t.to(d), params_cpu)
            opt = adamw(1e-3, weight_decay=0.0)
            st = opt.init(p)
            curve = []
            for step in range(3):
                loss, g = rt.train_step(p, [ds.batch(b, step)])
                p, st = opt.update(g, st, p)
                curve.append(float(loss))
                if ef and step == 0:
                    msgs = compressed_messages(rt.prog, plan)
                    held = nonzero_residuals(rt.ef_state)
                    if held != msgs or msgs == 0:
                        raise AssertionError(
                            f"EF on {d}: {held} non-zero residuals after "
                            f"step 1, expected {msgs}")
            curves[side] = curve
        gap = max(abs(x - y) / abs(y) for x, y in zip(curves["card"],
                                                      curves["cpu"]))
        name = "error-feedback" if ef else "compressed"
        if gap > 1e-3:
            raise AssertionError(f"card and CPU {name} loss curves differ: "
                                 f"{curves}")
        report.append(f"{name} smoke curve card {curves['card']} vs cpu "
                      f"{curves['cpu']} (max rel {gap:.3e})")
    print("reference checks: " + "; ".join(report))


SERVE_DEVICES = 8           # geo_random(8, seed=0): the simulated swarm
SERVE_STAGES = 3            # where the JAX reference's chain stops being
                            # bit-exact (ROADMAP Queue 3)
SERVE_CACHE_LEN, SERVE_MAX_BATCH = 64, 4
SERVE_REQUESTS, SERVE_RATE = 6, 200.0   # the launcher's traffic
SERVE_LEASE = 1e-5
SERVE_TIMING_REPS = 20
SERVE_PROMPT = 12           # prefill length timed


def serve_bound_ms(cfg, params, batch, tokens) -> dict:
    """Least time of one monolithic step over ``tokens`` new tokens a
    sequence at ``batch`` (decode: 1, prefill: the prompt) from the bytes it
    must move — every matmul weight read once (the blocks' projections and
    the head), the cache written once (and read once when decoding) — or
    from its fp32 matmul operations, whichever is larger."""
    from repro_torch.core.opgraph import tree_leaves
    w = [params["blocks"]["attn"][k]["w"] for k in ("wq", "wk", "wv", "wo")]
    w += [leaf for leaf in tree_leaves(params["blocks"]["mlp"])]
    w.append(params["embed"]["table"] if cfg.tie_embeddings
             else params["head"]["w"])
    weight_elems = sum(t.numel() for t in w)
    cache = (2 * cfg.n_layers * batch * SERVE_CACHE_LEN * cfg.n_kv_heads
             * cfg.head_dim * 4)
    nbytes = weight_elems * 4 + cache * (2 if tokens == 1 else 1)
    ops = 2 * batch * tokens * weight_elems
    ms = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
          "operations": 1e3 * ops / FP32_OPS_PER_S}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by, "weight_bytes":
            weight_elems * 4, "bytes": nbytes, "operations": ops}


def event_times_ms(fn, reps: int = SERVE_TIMING_REPS, warmup: int = 2):
    """Milliseconds of each of ``reps`` calls of ``fn``, CUDA events around
    each (the span from the first enqueued kernel to the last, gaps while
    the host enqueues included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def device_busy_ms(fn, reps: int = 3):
    """Summed kernel time per call of ``fn`` from the profiler's CUDA
    activity (``None`` where it saw no device time): what the card is busy
    for, against the call's event span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", 0) or 0
                for ev in prof.key_averages()
                if getattr(ev, "device_type", None)
                == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3 if total else None


def time_monolithic(cfg, params, dev) -> dict:
    """The monolithic gpt2-xl prefill (SERVE_PROMPT tokens) and one
    ``decode_step`` at batch 1 and at batch 4: median and spread of
    SERVE_TIMING_REPS calls (CUDA events), the profiler's kernel time a
    call, and the byte bound."""
    import statistics

    import torch
    from repro_torch.models import causal_lm

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for batch in (1, 4):
        prompt = torch.randint(0, cfg.vocab, (batch, SERVE_PROMPT),
                               generator=gen, device=dev)
        logits, cache = causal_lm.prefill(cfg, params, prompt,
                                          cache_len=SERVE_CACHE_LEN)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        calls = {"decode": (lambda: causal_lm.decode_step(cfg, params, cache,
                                                          tok), 1)}
        if batch == 1:
            calls["prefill"] = (lambda: causal_lm.prefill(
                cfg, params, prompt, cache_len=SERVE_CACHE_LEN),
                SERVE_PROMPT)
        for name, (fn, tokens) in calls.items():
            ms = event_times_ms(fn)
            row = {"median_ms": statistics.median(ms), "min_ms": min(ms),
                   "max_ms": max(ms), "reps": len(ms),
                   "kernel_ms": device_busy_ms(fn)}
            row.update(serve_bound_ms(cfg, params, batch, tokens))
            out[f"{name}_b{batch}"] = row
        del logits, cache
    return out


def monolithic_greedy(cfg, params, prompt, n_new, cache_len, dev,
                      execs=None):
    """Greedy decode of ``prompt`` for ``n_new`` tokens through the
    monolithic ``prefill`` + ``decode_step``; returns the tokens.  With
    ``execs`` (a chain of ``StageExecutor``s) the chain is fed the same
    tokens and its last-position logits must be bit-identical to the
    monolithic model's at every step."""
    import torch
    from repro_torch.models import causal_lm

    x = torch.tensor(prompt, dtype=torch.int32, device=dev)[None, :]
    ref, cache = causal_lm.prefill(cfg, params, x, cache_len=cache_len)
    kvs = []
    for ex in execs or ():
        x, kv = ex.prefill(x)
        kvs.append(kv)
    tokens = []
    for step in range(n_new):
        if execs and not bits_equal(x, ref):
            raise AssertionError(f"serve: staged and monolithic logits "
                                 f"differ at step {step} of a "
                                 f"{len(prompt)}-token prompt")
        tokens.append(int(torch.argmax(ref[0, -1, :])))
        if step == n_new - 1:
            break
        tok = torch.tensor([[tokens[-1]]], dtype=torch.int32, device=dev)
        ref, cache = causal_lm.decode_step(cfg, params, cache, tok)
        x = tok
        for i, ex in enumerate(execs or ()):
            x, kvs[i] = ex.decode(x, kvs[i], len(prompt) + step)
    return tokens


def run_serve_path(dev):
    """gpt2-xl full served the way ``repro_torch.launch.serve --churn``
    serves it: SERVE_STAGES stages over ``geo_random(8, seed=0)``, the
    launcher's 6-request Poisson traffic; the no-churn leg is
    ``derive_midsession_failure``'s dry run (as in the JAX serving
    benchmark), the churn leg ``run_leg`` with the victim it picks.  The
    codec's counts go from just before the legs to just after (serving runs
    no codec).  Then each request's tokens are held against the monolithic
    greedy loop on the card, the first request's with the staged chain's
    logits bit-identical at every step, and the monolithic prefill and
    decode are timed."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.network import geo_random
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.launch.serve import run_leg
    from repro_torch.models import causal_lm
    from repro_torch.serving import (ServingCostModel, StageExecutor,
                                     churn_trace_for,
                                     derive_midsession_failure,
                                     plan_serving, poisson_trace,
                                     stage_params)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = resolve("gpt2-xl").full
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = causal_lm.init(cfg, gen)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t_phase
    plan = plan_serving(cfg, ServingCostModel(
        cfg, geo_random(SERVE_DEVICES, seed=0)), list(range(SERVE_DEVICES)),
        n_stages=SERVE_STAGES, cache_len=SERVE_CACHE_LEN,
        max_batch=SERVE_MAX_BATCH)
    requests = poisson_trace(SERVE_REQUESTS, rate=SERVE_RATE,
                             vocab=cfg.vocab, prompt_len=(4, 12),
                             gen_len=(16, 32), seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)

    tk.reset_launch_counts()            # this path's counts start here
    t0 = time.perf_counter()
    victim, at, base, base_tokens = derive_midsession_failure(
        cfg, params, plan, requests, SERVE_DEVICES, lease_s=SERVE_LEASE,
        device=dev)
    torch.cuda.synchronize(dev)
    base_wall = time.perf_counter() - t0
    churn_tokens = {}
    t0 = time.perf_counter()
    churn, _, flight = run_leg(
        cfg, params, plan, requests, SERVE_DEVICES,
        churn_trace_for(victim, at), SERVE_LEASE, dev,
        on_token=lambda rid, tok, now:
            churn_tokens.setdefault(rid, []).append(tok))
    torch.cuda.synchronize(dev)
    churn_wall = time.perf_counter() - t0
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    if any(got.values()):
        raise AssertionError(f"serve: the codec ran on the serving path: "
                             f"{got}")
    if not (base.all_completed and churn.all_completed):
        raise AssertionError(f"serve: sessions dropped: {base} / {churn}")
    reroutes = [r for r in flight.records("route") if r.cause == "reroute"]
    if base.n_reroutes or churn.n_reroutes < 1 or not reroutes \
            or not all(r.replay_tokens > 0 for r in reroutes):
        raise AssertionError(f"serve: expected re-routes with a KV replay "
                             f"in the churn leg only: {base} / {churn}")
    if churn_tokens != base_tokens:
        raise AssertionError("serve: greedy tokens differ between the "
                             "legs: the KV replay is not bit-exact")
    t0 = time.perf_counter()
    execs = [StageExecutor(cfg, spec, stage_params(cfg, params, spec),
                           plan.cache_len, dev) for spec in plan.stages]
    for i, req in enumerate(requests):
        mono = monolithic_greedy(cfg, params, req.prompt, req.max_new_tokens,
                                 plan.cache_len, dev,
                                 execs if i == 0 else None)
        if mono != base_tokens[req.rid]:
            raise AssertionError(f"serve: {req.rid}: the runtime's tokens "
                                 f"differ from the monolithic greedy loop")
    check_s = time.perf_counter() - t0
    del execs
    timing = time_monolithic(cfg, params, dev)
    n_tok = sum(len(t) for t in base_tokens.values())
    report = {
        "model": cfg.name, "stages": [str(s) for s in plan.stages],
        "replicas": plan.replicas, "victim": victim, "fail_at_sim_s": at,
        "reroutes": [r.to_dict() for r in reroutes],
        "no_churn": {**base.to_dict(), "wall_s": base_wall,
                     "wall_tokens_per_s": n_tok / base_wall},
        "churn": {**churn.to_dict(), "wall_s": churn_wall,
                  "wall_tokens_per_s": n_tok / churn_wall},
        "allocated_before_gb": allocated / 1e9, "peak_mem_gb": peak / 1e9,
        "init_s": init_s, "monolithic_check_s": check_s,
        "monolithic": timing, "launches": got}
    print("serve path: " + json.dumps(report))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve path: {len(requests)} requests, tokens equal across the "
          f"legs and to the monolithic greedy loop, staged logits of "
          f"{requests[0].rid} bit-identical at all {requests[0].max_new_tokens} "
          f"steps; phase {time.perf_counter() - t_phase:.1f} s")
    return got


def moe_smoke_cfg():
    """``tests/test_serving.py``'s ``moe_cfg``: 4 layers, d_model 48, 4
    experts, top-2, tied embeddings."""
    from repro_torch.configs.base import ModelCfg
    return ModelCfg(name="serve-moe", family="moe", n_layers=4, d_model=48,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab=89, n_experts=4,
                    top_k=2, tie_embeddings=True)


def check_serve_smoke(dev):
    """The JAX serving benchmark's ``geo`` profile (llama3-8b smoke, GQA +
    RoPE, ``geo_random(8, 0)``, 2 stages, 10 requests at 100 req/s) through
    the dry run and the churn leg on the card and on the CPU from the same
    weights: equal tokens and exactly equal simulated reports.  Then the
    moe smoke model at 3 stages: staged equal to monolithic bit for bit on
    the card over a prefill and 4 decode steps, and the card's logits
    within rel 1e-5 of the CPU's (max |card - cpu| over max |cpu|)."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.network import geo_random
    from repro_torch.core.rad import tree_map
    from repro_torch.launch.serve import run_leg
    from repro_torch.models import causal_lm
    from repro_torch.serving import (ServingCostModel, churn_trace_for,
                                     derive_midsession_failure,
                                     plan_serving, poisson_trace,
                                     split_stages, stage_params,
                                     StageExecutor)

    cpu = torch.device("cpu")
    cfg = resolve("llama3-8b").smoke
    params = causal_lm.init(cfg, torch.Generator().manual_seed(0))
    plan = plan_serving(cfg, ServingCostModel(cfg, geo_random(8, seed=0)),
                        list(range(8)), n_stages=2, cache_len=64,
                        max_batch=4)
    requests = poisson_trace(10, rate=100.0, vocab=cfg.vocab,
                             prompt_len=(4, 12), gen_len=(16, 32), seed=0)
    sides = {}
    for side, d in (("card", dev), ("cpu", cpu)):
        p = tree_map(lambda t: t.to(d), params)
        victim, at, base, base_tokens = derive_midsession_failure(
            cfg, p, plan, requests, 8, lease_s=SERVE_LEASE, device=d)
        tokens = {}
        churn, _, _ = run_leg(cfg, p, plan, requests, 8,
                              churn_trace_for(victim, at), SERVE_LEASE, d,
                              on_token=lambda rid, tok, now:
                                  tokens.setdefault(rid, []).append(tok))
        sides[side] = (victim, at, base.to_dict(), churn.to_dict(),
                       base_tokens, tokens)
    if sides["card"] != sides["cpu"]:
        raise AssertionError("serve smoke (geo): card and CPU differ")
    victim, at, base, churn, base_tokens, tokens = sides["card"]
    if base_tokens != tokens or churn["n_reroutes"] < 1:
        raise AssertionError("serve smoke (geo): churn changed the tokens "
                             "or re-routed nothing")

    cfg = moe_smoke_cfg()
    params = causal_lm.init(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (1, 6),
                           generator=torch.Generator().manual_seed(1))
    logits = {}
    for side, d in (("card", dev), ("cpu", cpu)):
        p = tree_map(lambda t: t.to(d), params)
        ref, cache = causal_lm.prefill(cfg, p, prompt.to(d), cache_len=24)
        execs = [StageExecutor(cfg, s, stage_params(cfg, p, s), 24, d)
                 for s in split_stages(cfg, 3)]
        x, kvs = prompt.to(d), []
        for ex in execs:
            x, kv = ex.prefill(x)
            kvs.append(kv)
        out = [ref]
        tok = torch.argmax(ref[:, -1, :], dim=-1)[:, None]
        for step in range(4):
            if side == "card" and not bits_equal(x, ref):
                raise AssertionError(f"serve smoke (moe): staged != "
                                     f"monolithic on the card, step {step}")
            ref, cache = causal_lm.decode_step(cfg, p, cache, tok)
            x = tok
            for i, ex in enumerate(execs):
                x, kvs[i] = ex.decode(x, kvs[i], 6 + step)
            out.append(ref)
            tok = torch.argmax(ref[:, -1, :], dim=-1)[:, None]
        if side == "card" and not bits_equal(x, ref):
            raise AssertionError("serve smoke (moe): staged != monolithic "
                                 "on the card, last step")
        logits[side] = torch.cat([o.cpu() for o in out])
    gap = float((logits["card"] - logits["cpu"]).abs().max()
                / logits["cpu"].abs().max())
    if gap > 1e-5:
        raise AssertionError(f"serve smoke (moe): card and CPU logits differ "
                             f"by rel {gap}")
    print("serve smoke checks: " + json.dumps({
        "geo": {"victim": victim, "at": at, "no_churn": base,
                "churn": churn},
        "moe_3_stages": {"staged_equals_monolithic_on_card": True,
                         "max_rel_logit_gap_card_cpu": gap}}))


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import topk_compress as tk

    dev = resolve_device("cuda")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = tk.build_library()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text().strip())
    print("kernels: " + json.dumps({n: {"route": "cuda", "source": SOURCE,
                                        "replaces": REPLACES[n]}
                                    for n in tk.KERNELS}))

    err = check_kernels(dev)
    timing = measure_kernels(dev)
    training = run_training_path(dev)
    paths = {f"train {label}": r["launches"]
             for label, r in training.items()}
    cases = {(tuple(shape), k) for r in training.values()
             for shape, k in r["codec_cases"]}
    paths["train gspmd"] = run_gspmd_path(dev)
    paths["train elastic"], elastic_cases = run_elastic_path(dev)
    paths["serve"] = run_serve_path(dev)
    paths["entry points"] = run_entry_points(dev)
    launches = {n: sum(p[n] for p in paths.values()) for n in tk.KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{launches}")
    if not elastic_cases or not cases:
        raise AssertionError("a training path ran no compressed boundary")
    for name, e in check_path_cases(dev, cases | elastic_cases).items():
        err[name] = max(err[name], e)
    check_against_reference(dev)
    check_gspmd_smoke(dev)
    check_elastic_smoke(dev)
    check_serve_smoke(dev)

    main_shape = timing[(BATCH, SEQ, 1600)]
    kernels = []
    for name, short in (("encode_topk", "encode"),
                        ("ef_encode_topk", "ef_encode"),
                        ("decode_topk", "decode"),
                        ("blockwise_topk_mask", "blockwise_topk_mask"),
                        ("ef_topk", "ef_topk")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err[name], "ms": main_shape[f"{short}_ms"],
            "device_us": main_shape[f"{short}_device_us"],
            "host_us": main_shape[f"{short}_host_us"],
            "plain_ms": main_shape[f"{short}_plain_ms"],
            "bound_ms": main_shape[f"{short}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "yardstick": {"call": "torch.topk(|x|.view(nb, 4096), k, dim=1)",
                          "computes": "selection only",
                          "ms": main_shape["topk_selection_only_ms"]},
            "shape": main_shape["shape"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
