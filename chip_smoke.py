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
   and migration; the obs kit (trace, flight and metrics recorders and a
   watchdog) rides along, and the recorded trace is what 16 analyses;
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
9. drives the hybrid family's serving path — zamba2-7b at full width and
   depth (81 layers: 13 groups of 6 Mamba2 blocks, each followed by one of
   2 alternating shared attention + MLP blocks, then 3 Mamba2 blocks;
   random weights from seed 0, fp32) through ``steps.make_prefill_step`` /
   ``make_decode_step``, the JAX package's entry points for a family it
   never stage-shards: a 128-token prompt (one SSD chunk) at batch 1 and
   128 greedy tokens against a cache of 512, the codec's counts set to 0
   just before and read just after (all stay 0); it holds the decoded
   logits against a teacher-forced ``causal_lm.forward`` over the 256
   tokens (within 1e-3 of the largest |logit|, and the same argmax
   wherever the forward's top-2 margin is over 10 times the gap), holds
   ``ssd_chunked`` against ``ssd_reference`` at the full head shape, and
   prints the decode step (batch 1 and 4) and the prefill (128 and 512
   tokens) in ms (median of 20, CUDA events) beside the profiler's kernel
   time and the bound, and the peak memory;
10. drives the xLSTM family — xlstm-1.3b at full width and depth (48
   layers: 6 groups of 7 mLSTM blocks and one sLSTM block; d_model 2048;
   random weights from seed 0, fp32): serves a 128-token prompt at batch 1
   and 128 greedy tokens through ``steps.make_prefill_step`` /
   ``make_decode_step`` and trains 3 Adafactor steps (batch 4, seq 256)
   through ``make_train_step``, the codec's counts set to 0 just before
   each and read just after (all stay 0); it holds the decoded logits
   against a teacher-forced ``causal_lm.forward`` as in 9, step 1's loss
   against ``train_loss`` (rel 1e-6) and every loss finite, prints the
   decode step (batch 1 and 4) and the prefill (128 and 512 tokens) in ms
   beside the profiler's kernel time and the bound, the step seconds,
   tokens/s, FLOP bound and peak memory, and holds xlstm-smoke and a
   5-layer variant with an mlstm tail on the card against the CPU (prefill,
   4 decode steps with their caches, one step's loss and gradients, within
   rel 1e-5);
11. drives the encoder-decoder — seamless-m4t-large-v2 at full width and
   depth (12 encoder + 12 decoder layers, d_model 1024, vocab 256,206
   padded to 256,256; random weights from seed 0, fp32): serves 64 frame
   embeddings (``steps.src_len_for(cfg, 512)``) and an 8-token target
   prefix at batch 1 with a cache of 512, then 128 greedy tokens, through
   ``steps.make_prefill_step`` / ``make_decode_step``, and trains 3 AdamW
   steps (batch 8, 256 target tokens over 32 frames, ``SyntheticSeq2Seq``)
   through ``make_train_step``, the codec's counts set to 0 just before
   each and read just after (all stay 0); it holds the served logits
   against a teacher-forced ``encdec._decoder_train`` on the same memory
   as in 9, step 1's loss against ``train_loss`` (rel 1e-6) and every loss
   finite, prints the decode step (batch 1 and 4) and the prefill (64
   frames × 8 tokens, 512 × 512) in ms beside the profiler's kernel time
   and the bound, the step seconds, target tokens/s, FLOP bound and peak
   memory, and holds seamless-smoke and a 2 + 2-layer variant with a
   padded vocabulary on the card against the CPU (prefill, 4 decode steps
   with their caches, one step's loss and gradients, within rel 1e-5);
12. drives the error-feedback and dense entry points (``ef_compress``,
   ``ops.topk_mask``, ``ops.ef_topk``) over 5 steps with the residual
   carried, counting their launches, and holds ``ef_compress`` bit-exact
   against the EF training step's own composition on the card and against
   the CPU's plain version;
13. drives the GPipe pipeline (``distributed.pipeline``) — gpt2-xl at full
   width and depth, random weights from seed 0, fp32, batch 8 × 128 of
   ``SyntheticLM`` in 4 micro-batches of 2, all eight mesh positions on
   the card: on the ``(8,)`` model mesh (no compression) its loss and
   gradients against ``make_train_step``'s autograd (rel 1e-6 / 1e-5 as
   one vector); on the ``(2, 4)`` pod × model mesh with ``use_kernel=
   "auto"`` one loss and gradient at base ratio 1 (the pod edge at ratio
   3, k = 1,366 a block) and 4 AdamW steps at base ratio 10 (ratio 30, k
   = 137), each call held to 8 encodes and 8 decodes (4 micro-batches,
   forward and backward, on edge 3 -> 4), one more step under the
   profiler (the codec's share of the kernel time), then 3 gspmd steps
   from the same weights and AdamW state; it prints the steady step
   seconds, tokens/s, peak memory, the FLOP bound (``analysis.roofline``
   at the fp32 peak) and the gspmd step beside it;
14. holds ``encode_topk`` and ``decode_topk`` bit-exact against their plain
   versions at every (boundary shape, k a block) that the training,
   elastic and pipeline paths gave them, derived from each step's plan;
15. checks the output the repository's way: finite losses, RAD equal to
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
    the CPU's), and zamba2-smoke on the card against the CPU (a prefill, 4
    decode steps, the forward and the loss within rel 1e-5), and the
    pipeline at the JAX reference test's sizes (gpt2-smoke with 8 layers,
    8 × 32, 4 micro-batches) on the card against the CPU (uncompressed
    loss and gradients, compressed loss, within rel 1e-5);
16. analyses the elastic path's trace (7): written as JSONL, it passes
    ``python -m repro_torch.obs.export --validate --check-order`` and
    ``python -m repro_torch.obs.critpath --expect-busy`` against the
    controller's ``sim_*_busy_seconds`` counters; the happens-before check
    finds no error, every attempt's critical path covers its makespan,
    which equals its step record's simulated seconds, and the failure
    epoch re-priced by ``obs.whatif`` equals its recorded step; the same
    controller run timing-only with and without the kit gives the trained
    run's step and epoch records (tracing changes no simulated number);
    it prints the blame table, the what-if ranking over the failure epoch
    and the length of each section of ``obs.report``;
17. runs ``python -m repro_torch.check --all-configs --lint --docs`` (every
    arch's smoke OP-DAG planned and checked, the port's lint, the docs'
    links): rc 0;
18. runs the port's dry run (``launch.dryrun.run_one``) for every arch ×
    shape on the 16×16 and 2×16×16 production meshes in bf16, with
    nothing allocated on any device: each record ``ok`` (or ``skipped``
    where the registry skips the shape), its argument bytes equal to the
    sum this script takes again over the shardings; it prints the
    argument GiB per device by arch and shape.

Every phase raises on failure (exit code 1).  Without a CUDA device, or
without ``src/repro_torch`` beside it, it exits with code 2 and prints no
result.  The last line of standard output is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
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
ELASTIC_RATIO = 100.0       # the joint planner's AdaTopK ratio
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
    the kernels' launches counted from just before the run to just after,
    with the whole obs kit attached (a ``TraceRecorder``, a
    ``FlightRecorder``, a ``MetricsRegistry`` and a ``Watchdog``).
    Returns the path's launch counts, the (shape, k a block) of every
    compressed boundary it ran, and what ``check_analysis`` reads: the
    recorded events, the flight records, the metrics with the
    simulator's ``sim_*_busy_seconds`` counters, the step and epoch
    records, and the run's configuration."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core import network
    from repro_torch.data import SyntheticLM
    from repro_torch.elastic import ElasticController
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.models.opgraph_models import gpt_opgraph
    from repro_torch.obs import (FlightRecorder, MetricsRegistry,
                                 TraceRecorder, Watchdog)
    from repro_torch.optim import adamw

    print(f"elastic: host MemTotal {mem_total()}")
    cfg = resolve("gpt2-xl").full
    graph = gpt_opgraph(cfg, BATCH, SEQ)
    shapes = {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ)}
    prof = graph.annotate(shapes)
    cluster = network.paper_testbed(1, seed=0)
    t1, victim, trace = probe_failure(graph, prof, cluster, dev, "joint",
                                      ELASTIC_RATIO, ELASTIC_STEPS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the list hands the controller the only reference to the initial
    # weights, which it drops at the first update
    params = [graph.init(gen, shapes)]
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0, order=1)
    meter = ElasticMeter(dev)
    kit = dict(tracer=TraceRecorder(), flight=FlightRecorder(),
               metrics=MetricsRegistry(), watchdog=Watchdog())
    ctrl = ElasticController(
        graph, prof, cluster, trace, optimizer=meter.optimizer(adamw(3e-4)),
        n_micro=2, lease_s=1.5 * t1, migration_mode="stop",
        planner="joint", joint_ratio=ELASTIC_RATIO, use_kernel="auto",
        checkpoint_interval=3, checkpoint_history=2, device=dev, **kit)
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
    traced = {"recorder": kit["tracer"], "events": kit["tracer"].events(),
              "flight": [r.to_dict() for r in kit["flight"].records()],
              "metrics": kit["metrics"].snapshot(),
              "watchdog_trips": len(kit["watchdog"].records),
              "steps": [dataclasses.asdict(r) for r in res.steps],
              "epochs": [dataclasses.asdict(e) for e in res.epochs],
              "total_seconds": res.total_seconds,
              "graph": graph, "profiles": prof, "cluster": cluster,
              "churn": trace, "lease_s": 1.5 * t1,
              "schedule": ctrl.schedule, "plan": ctrl.plan,
              "true_cluster": ctrl.true_cluster(),
              "kernel_costs": dict(ctrl.kernel_costs), "wall_s": wall}
    del res, ctrl
    gc.collect()
    torch.cuda.empty_cache()
    return got, meter.cases, traced


def check_elastic_smoke(dev):
    """The elastic example's smoke configuration (6 layers, d_model 64,
    batch 8, seq 32, joint planner at AdaTopK ratio 8) through one failure,
    on the card and on the CPU from the same weights, in stop and overlap
    mode: the epoch and step records and the simulated clock must be
    identical, the losses within rel 1e-3.  Under the dense planner the
    card's run through the failure must give the losses of a run with no
    failure, step for step, within rel 1e-6."""
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


HYBRID_ARCH = "zamba2-7b"
HYBRID_CACHE_LEN = 512
HYBRID_PROMPT = 128         # one SSD chunk: prompts are multiples of 128
HYBRID_NEW = 128            # greedy decode steps
HYBRID_GAP = 1e-3           # decode vs forward logits, rel to max |logit|
HYBRID_PREFILLS = (128, 512)
HYBRID_SMOKE_GAP = 1e-5     # zamba2-smoke, card vs CPU, rel
# ssd_chunked vs the literal recurrence, rel to max |y|: the chunked form
# takes exp of differences of cumulative log-decays that reach a few
# hundred over a 128-token chunk here, so fp32 leaves ~1e-5 (7.9e-6 on
# the CPU; the JAX package's own test holds it at atol 1e-4 on unit-scale
# inputs)
SSD_GAP = 1e-4


def hybrid_bound_ms(cfg, batch, tokens, cache_len, kv_len) -> dict:
    """Least time of one zamba2 call over ``tokens`` new tokens a sequence
    at ``batch`` (decode: 1 against ``kv_len`` cached positions, prefill:
    the prompt) from the config: the bytes it must move — every weight read
    once per use (each Mamba2 layer; the shared block once for each group
    that runs it; the head), the Mamba2 states and the shared blocks' KV
    cache of ``cache_len`` written once (and read once when decoding), the
    logits written — or its fp32 operations (matmuls, conv, SSD, attention
    scores), whichever is larger."""
    from repro_torch.models import causal_lm, ssm

    mc = causal_lm._mamba_cfg(cfg)
    d, V = cfg.d_model, cfg.vocab_padded
    segs = causal_lm.segments(cfg)
    n_mamba = sum(s.count * (s.inner or 1) for s in segs)
    n_groups = sum(s.count for s in segs if s.kind == "zamba_group")
    di, ds, nh, hd = mc.d_inner, mc.d_state, mc.n_heads, mc.head_dim
    conv_ch = di + 2 * ds
    mamba_w = (d * (2 * di + 2 * ds + nh) + di * d      # in_proj, out_proj
               + conv_ch * (mc.conv_width + 1) + 3 * nh + di + d)
    qkvo = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp_w = d * cfg.d_ff * 3
    shared_w = qkvo + mlp_w + 2 * d
    weights = {"mamba": n_mamba * mamba_w, "shared": n_groups * shared_w,
               "head": d * V}
    state = n_mamba * batch * (nh * ds * hd + (mc.conv_width - 1) * conv_ch)
    kv = n_groups * 2 * batch * cache_len * cfg.n_kv_heads * cfg.head_dim
    nbytes = 4 * (sum(weights.values()) + batch * tokens * d
                  + (state + kv) * (2 if tokens == 1 else 1) + batch * V)
    T = batch * tokens
    if tokens == 1:     # the recurrence: the chunked form's chunks of one
        mamba_ops = ssm.mamba_flops(T, mc._replace(chunk=1))
        scores = 4 * batch * kv_len * cfg.n_heads * cfg.head_dim
    else:
        mamba_ops = ssm.mamba_flops(T, mc)
        scores = 4 * batch * (tokens * (tokens + 1) // 2) * cfg.n_heads \
            * cfg.head_dim
    ops = (n_mamba * mamba_ops
           + n_groups * (2 * T * (qkvo + mlp_w) + scores)
           + 2 * batch * d * V)                         # head: last position
    ms = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
          "operations": 1e3 * ops / FP32_OPS_PER_S}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by,
            "weight_bytes_per_use": {k: 4 * v for k, v in weights.items()},
            "bytes": nbytes, "operations": ops}


def time_hybrid(cfg, params, dev) -> dict:
    """zamba2 full through the step builders: ``decode_step`` at batch 1
    and 4 (against a cache from a HYBRID_PROMPT-token prefill) and the
    prefill of each of HYBRID_PREFILLS tokens at batch 1: median and spread
    of SERVE_TIMING_REPS calls (CUDA events), the profiler's kernel time a
    call (one call profiled: a step makes ~7,000 host calls), and the
    bound."""
    import statistics

    import torch
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step)

    prefill = make_prefill_step(cfg, cache_len=HYBRID_CACHE_LEN)
    decode = make_decode_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def row(fn, batch, tokens, kv_len):
        ms = event_times_ms(fn)
        out = {"median_ms": statistics.median(ms), "min_ms": min(ms),
               "max_ms": max(ms), "reps": len(ms),
               "kernel_ms": device_busy_ms(fn, reps=1)}
        out.update(hybrid_bound_ms(cfg, batch, tokens, HYBRID_CACHE_LEN,
                                   kv_len))
        return out

    out = {}
    for batch in (1, 4):
        prompt = torch.randint(0, cfg.vocab, (batch, HYBRID_PROMPT),
                               generator=gen, device=dev)
        logits, cache = prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out[f"decode_b{batch}"] = row(lambda: decode(params, cache, tok),
                                      batch, 1, HYBRID_PROMPT + 1)
        del logits, cache
    for S in HYBRID_PREFILLS:
        prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                               device=dev)
        out[f"prefill_{S}_b1"] = row(
            lambda: prefill(params, {"tokens": prompt}), 1, S, 0)
    return out


def check_ssd_full_heads(cfg, dev) -> float:
    """``ssd_chunked`` against ``ssd_reference`` on the card at the config's
    full head shape (S = 2 chunks); returns max |chunked - reference| over
    max |reference|."""
    import torch
    from repro_torch.models import causal_lm, ssm

    mc = causal_lm._mamba_cfg(cfg)
    S = 2 * mc.chunk
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device=dev)
    x, dt = rnd(1, S, mc.n_heads, mc.head_dim), ssm.softplus(
        rnd(1, S, mc.n_heads) - 2.0)
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, mc.n_heads,
                                            device=dev)))
    Bm, Cm, D = rnd(1, S, mc.d_state), rnd(1, S, mc.d_state), rnd(mc.n_heads)
    y, _ = ssm.ssd_chunked(x, dt, A, Bm, Cm, D, mc.chunk)
    ref = ssm.ssd_reference(x, dt, A, Bm, Cm, D)
    return float((y - ref).abs().max() / ref.abs().max())


def run_hybrid_serve_path(dev):
    """zamba2-7b full (81 layers, d_model 3584; random weights from seed 0,
    fp32) served through ``steps.make_prefill_step`` / ``make_decode_step``
    — the JAX package's serving entry points for a recurrent family, which
    it never stage-shards: a HYBRID_PROMPT-token prompt at batch 1, then
    HYBRID_NEW greedy tokens, the codec's counts set to 0 just before and
    read just after (serving runs no codec).  A teacher-forced
    ``causal_lm.forward`` over the same tokens holds the decoded logits
    (within HYBRID_GAP of the largest |logit|, and the same argmax wherever
    the forward's top-2 margin is over 10 times the gap); ``ssd_chunked``
    is held against ``ssd_reference`` at the full head shape; the decode
    step and the prefill are timed beside their bound."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step)
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.models import causal_lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = resolve(HYBRID_ARCH).full
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = causal_lm.init(cfg, gen)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t_phase
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != causal_lm.count_params(cfg):
        raise AssertionError(f"serve hybrid: init drew {n_params} "
                             f"parameters, count_params says "
                             f"{causal_lm.count_params(cfg)}")
    prefill = make_prefill_step(cfg, cache_len=HYBRID_CACHE_LEN)
    decode = make_decode_step(cfg)
    prompt = torch.randint(0, cfg.vocab, (1, HYBRID_PROMPT), generator=gen,
                           device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)

    tk.reset_launch_counts()            # this path's counts start here
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt})
    tokens, decoded = [], []
    for _ in range(HYBRID_NEW):
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        tokens.append(tok)
        logits, cache = decode(params, cache, tok)
        decoded.append(logits[:, -1, :])
    torch.cuda.synchronize(dev)
    serve_s = time.perf_counter() - t0
    got = launch_counts()
    if any(got.values()):
        raise AssertionError(f"serve hybrid: the codec ran on the serving "
                             f"path: {got}")
    if int(cache["pos"]) != HYBRID_PROMPT + HYBRID_NEW:
        raise AssertionError(f"serve hybrid: cache at {int(cache['pos'])}")
    del cache

    seq = torch.cat([prompt] + tokens, dim=1)           # 256 tokens
    with torch.inference_mode():
        full, _ = causal_lm.forward(cfg, params, seq)
    # the decoded positions, over the true vocabulary (not the -1e30 pad)
    ref = full[0, HYBRID_PROMPT:, :cfg.vocab]
    got_logits = torch.cat(decoded)[:, :cfg.vocab]
    if not (torch.isfinite(got_logits).all() and torch.isfinite(ref).all()):
        raise AssertionError("serve hybrid: non-finite logits")
    gap_abs = float((got_logits - ref).abs().max())
    gap = gap_abs / float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 10 * gap_abs
    same = torch.argmax(got_logits, -1) == torch.argmax(ref, -1)
    n_clear = int(clear.sum())
    if gap > HYBRID_GAP or not bool(same[clear].all()):
        raise AssertionError(
            f"serve hybrid: decode vs forward rel gap {gap:.3e} (limit "
            f"{HYBRID_GAP}); argmax differs at "
            f"{int((~same & clear).sum())} of {n_clear} clear positions")
    del full, ref, got_logits
    ssd_gap = check_ssd_full_heads(cfg, dev)
    if ssd_gap > SSD_GAP:
        raise AssertionError(f"serve hybrid: ssd_chunked vs ssd_reference "
                             f"rel {ssd_gap:.3e} at the full head shape")
    timing = time_hybrid(cfg, params, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    report = {
        "model": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": n_params,
        "segments": [s._asdict() for s in causal_lm.segments(cfg)],
        "cache_len": HYBRID_CACHE_LEN, "prompt": HYBRID_PROMPT,
        "new_tokens": HYBRID_NEW, "serve_s": serve_s,
        "tokens_per_s": HYBRID_NEW / serve_s,
        "decode_vs_forward": {
            "max_abs_gap": gap_abs, "rel_gap": gap,
            "clear_positions": n_clear,
            # positions (after the prompt) whose argmax differs, each with
            # the forward's top-2 margin: all below 10 times the gap
            "argmax_differs": [[i, float(top2[i, 0] - top2[i, 1])]
                               for i in torch.nonzero(~same).flatten()
                               .tolist()]},
        "ssd_chunked_vs_reference_rel": ssd_gap,
        "allocated_before_gb": allocated / 1e9, "peak_mem_gb": peak / 1e9,
        "init_s": init_s, "timing": timing, "launches": got}
    print("serve hybrid path: " + json.dumps(report))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve hybrid path: {HYBRID_NEW} greedy tokens, decode vs forward "
          f"rel gap {gap:.2e}, argmax equal at {n_clear} clear positions; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return got


def check_hybrid_smoke(dev):
    """zamba2-smoke with the same weights on the card and on the CPU: a
    prefill and 4 decode steps (both fed the CPU's greedy tokens), the
    forward and ``train_loss``; the largest gap relative to the CPU's
    largest |value| must stay within HYBRID_SMOKE_GAP."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.rad import tree_map
    from repro_torch.models import causal_lm

    cpu = torch.device("cpu")
    cfg = resolve(HYBRID_ARCH).smoke
    params = causal_lm.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 3 * cfg.ssm_chunk + 1),
                         generator=torch.Generator().manual_seed(1))
    S0 = 2 * cfg.ssm_chunk
    out = {}
    feed = None
    for side, d in (("cpu", cpu), ("card", dev)):
        p = tree_map(lambda t: t.to(d), params)
        logits, cache = causal_lm.prefill(cfg, p, toks[:, :S0].to(d),
                                          cache_len=S0 + 8)
        steps = [logits]
        fed = []
        for i in range(4):
            tok = (torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                   if feed is None else feed[i].to(d))
            fed.append(tok.cpu())
            logits, cache = causal_lm.decode_step(cfg, p, cache, tok)
            steps.append(logits)
        feed = fed
        batch = {"tokens": toks[:, :-1].to(d), "labels": toks[:, 1:].to(d)}
        fwd, _ = causal_lm.forward(cfg, p, batch["tokens"])
        loss, _ = causal_lm.train_loss(cfg, p, batch)
        out[side] = (torch.cat([s.cpu() for s in steps], dim=1), fwd.cpu(),
                     loss.cpu())
    gaps = {name: float((a - b).abs().max() / b.abs().max())
            for name, a, b in zip(("decode", "forward", "loss"),
                                  out["card"], out["cpu"])}
    if max(gaps.values()) > HYBRID_SMOKE_GAP:
        raise AssertionError(f"hybrid smoke: card and CPU differ: {gaps}")
    print("hybrid smoke checks: " + json.dumps(
        {"model": cfg.name, "max_rel_gap_card_cpu": gaps}))


XLSTM_ARCH = "xlstm-1_3b"
XLSTM_PROMPT = 128
XLSTM_NEW = 128             # greedy decode steps
XLSTM_CACHE_LEN = XLSTM_PROMPT + XLSTM_NEW  # no KV: the builders ignore it
XLSTM_GAP = 1e-3            # decode vs forward logits, rel to max |logit|
XLSTM_PREFILLS = {128: SERVE_TIMING_REPS, 512: 10}  # prompt: timed calls
XLSTM_TRAIN_STEPS = 3       # Adafactor steps at full size
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 4, 256
XLSTM_SMOKE_GAP = 1e-5      # xlstm-smoke and its tailed variant, card vs CPU


def xlstm_bound_ms(cfg, batch, tokens) -> dict:
    """Least time of one xLSTM call over ``tokens`` new tokens a sequence at
    ``batch`` (decode: 1, prefill: the prompt) from the config: the bytes it
    must move — every weight but the embedding table read once (the blocks
    and the head), the input embeddings read, the recurrent states (each
    mLSTM's C, n, m and conv tail; each sLSTM's c, n, h, m) written once
    (and read once when decoding), the last position's logits written — or
    its fp32 operations (``mlstm_flops`` / ``slstm_flops``, the decode's
    C update and read-out, the head), whichever is larger."""
    from repro_torch.models import causal_lm, xlstm

    xc = causal_lm._xlstm_cfg(cfg)
    d, V = cfg.d_model, cfg.vocab_padded
    segs = causal_lm.segments(cfg)
    n_s = sum(s.count for s in segs if s.kind == "xlstm_group")
    n_m = cfg.n_layers - n_s
    nh, hd, di = xc.n_heads, xc.head_dim_m, xc.d_inner_m
    weights = causal_lm.count_params(cfg) - V * d     # all but the table
    state = batch * (n_m * (nh * hd * hd + nh * hd + nh
                            + (xc.conv_width - 1) * di)
                     + n_s * 4 * nh * xc.head_dim_s)
    nbytes = 4 * (weights + batch * tokens * d
                  + state * (2 if tokens == 1 else 1) + batch * V)
    T = batch * tokens
    ops = (n_m * xlstm.mlstm_flops(T, tokens, xc)
           + n_s * xlstm.slstm_flops(T, xc) + 2 * batch * d * V)
    if tokens == 1:     # C = f C + i v k^T and C q: 6 operations an entry
        ops += n_m * 6 * T * nh * hd * hd
    ms = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
          "operations": 1e3 * ops / FP32_OPS_PER_S}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by, "weight_bytes": 4 * weights,
            "state_bytes": 4 * state, "bytes": nbytes, "operations": ops}


def time_xlstm(cfg, params, dev) -> dict:
    """xlstm-1.3b full through the step builders: ``decode_step`` at batch
    1 and 4 (against a cache from an XLSTM_PROMPT-token prefill), SERVE_
    TIMING_REPS calls each, and the prefill of each prompt of
    XLSTM_PREFILLS at batch 1 for its count of calls (CUDA events): median
    and spread, the profiler's kernel time of one call, the bound, and the
    greedy tokens/s of the median decode step."""
    import statistics

    import torch
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step)

    prefill = make_prefill_step(cfg, cache_len=XLSTM_CACHE_LEN)
    decode = make_decode_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def row(fn, batch, tokens, reps=SERVE_TIMING_REPS):
        ms = event_times_ms(fn, reps=reps)
        out = {"median_ms": statistics.median(ms), "min_ms": min(ms),
               "max_ms": max(ms), "reps": len(ms),
               "kernel_ms": device_busy_ms(fn, reps=1)}
        out.update(xlstm_bound_ms(cfg, batch, tokens))
        return out

    out = {}
    for batch in (1, 4):
        prompt = torch.randint(0, cfg.vocab, (batch, XLSTM_PROMPT),
                               generator=gen, device=dev)
        logits, cache = prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        r = row(lambda: decode(params, cache, tok), batch, 1)
        r["greedy_tokens_per_s"] = 1e3 * batch / r["median_ms"]
        out[f"decode_b{batch}"] = r
        del logits, cache
    for S, reps in XLSTM_PREFILLS.items():
        prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                               device=dev)
        out[f"prefill_{S}_b1"] = row(
            lambda: prefill(params, {"tokens": prompt}), 1, S, reps)
    return out


def train_xlstm(cfg, params, dev) -> dict:
    """XLSTM_TRAIN_STEPS steps of ``make_train_step(cfg, adafactor(1e-3))``
    (the JAX package's default optimizer for its step builders) from
    ``params`` on ``SyntheticLM`` data (seed 0, order 1) through
    ``ShardedLoader``; step 1's loss is held against ``train_loss`` on the
    same batch and weights (rel 1e-6), and every loss must be finite."""
    import torch
    from repro_torch.data import ShardedLoader, SyntheticLM
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import causal_lm
    from repro_torch.optim import adafactor

    B, S = XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ
    opt = adafactor(1e-3)
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=S, seed=0, order=1)
    loader = ShardedLoader((ds.batch(B, i) for i in range(XLSTM_TRAIN_STEPS)),
                           dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = opt.init(params)
    losses, step_s, first_ref = [], [], None
    for i in range(XLSTM_TRAIN_STEPS):
        batch = next(loader)
        if i == 0:
            with torch.no_grad():
                first_ref = float(causal_lm.train_loss(cfg, params,
                                                       batch)[0])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"xlstm train: non-finite loss {losses}")
    rel = abs(losses[0] - first_ref) / abs(first_ref)
    if rel > 1e-6:
        raise AssertionError(f"xlstm train: step 1's loss {losses[0]} vs "
                             f"train_loss {first_ref} (rel {rel:.3e})")
    steady = step_s[1:]
    non_embed = causal_lm.count_params(cfg) - cfg.vocab_padded * cfg.d_model
    flops = 6 * non_embed * B * S
    return {"batch": B, "seq": S, "optimizer": "adafactor(1e-3)",
            "losses": losses, "train_loss_step1": first_ref,
            "step1_rel_gap": rel, "step_s": step_s,
            "steady_step_s": sum(steady) / len(steady),
            "tokens_per_s": B * S * len(steady) / sum(steady),
            "flop_bound_ms": 1e3 * flops / FP32_OPS_PER_S,
            "flops": flops, "peak_mem_gb": peak / 1e9}


def run_xlstm_path(dev):
    """xlstm-1.3b full (48 layers: 6 groups of 7 mLSTM blocks and one
    sLSTM block; d_model 2048; random weights from seed 0, fp32) served
    through ``steps.make_prefill_step`` / ``make_decode_step`` — an
    XLSTM_PROMPT-token prompt at batch 1, then XLSTM_NEW greedy tokens — and
    trained for XLSTM_TRAIN_STEPS Adafactor steps through
    ``make_train_step``, the codec's counts set to 0 just before each and
    read just after (neither runs the codec, as in JAX).  A teacher-forced
    ``causal_lm.forward`` over the served tokens holds the decoded logits
    (the recurrence against the parallel form: within XLSTM_GAP of the
    largest |logit|, and the same argmax wherever the forward's top-2 margin
    is over 10 times the gap); the decode step and the prefill are timed
    beside their bound; then ``check_xlstm_smoke``."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step)
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.models import causal_lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = resolve(XLSTM_ARCH).full
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = causal_lm.init(cfg, gen)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t_phase
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != causal_lm.count_params(cfg):
        raise AssertionError(f"xlstm: init drew {n_params} parameters, "
                             f"count_params says "
                             f"{causal_lm.count_params(cfg)}")
    prefill = make_prefill_step(cfg, cache_len=XLSTM_CACHE_LEN)
    decode = make_decode_step(cfg)
    prompt = torch.randint(0, cfg.vocab, (1, XLSTM_PROMPT), generator=gen,
                           device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)

    tk.reset_launch_counts()            # the serving run's counts start here
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt})
    tokens, decoded = [], []
    for _ in range(XLSTM_NEW):
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        tokens.append(tok)
        logits, cache = decode(params, cache, tok)
        decoded.append(logits[:, -1, :])
    torch.cuda.synchronize(dev)
    serve_s = time.perf_counter() - t0
    got = launch_counts()
    serve_peak = torch.cuda.max_memory_allocated(dev)
    if int(cache["pos"]) != XLSTM_PROMPT + XLSTM_NEW:
        raise AssertionError(f"xlstm: cache at {int(cache['pos'])}")
    del cache

    seq = torch.cat([prompt] + tokens, dim=1)
    with torch.inference_mode():
        full, _ = causal_lm.forward(cfg, params, seq)
    # the decoded positions, over the true vocabulary (not the -1e30 pad)
    ref = full[0, XLSTM_PROMPT:, :cfg.vocab]
    got_logits = torch.cat(decoded)[:, :cfg.vocab]
    if not (torch.isfinite(got_logits).all() and torch.isfinite(ref).all()):
        raise AssertionError("xlstm: non-finite logits")
    gap_abs = float((got_logits - ref).abs().max())
    gap = gap_abs / float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 10 * gap_abs
    same = torch.argmax(got_logits, -1) == torch.argmax(ref, -1)
    n_clear = int(clear.sum())
    if gap > XLSTM_GAP or not bool(same[clear].all()):
        raise AssertionError(
            f"xlstm: decode vs forward rel gap {gap:.3e} (limit "
            f"{XLSTM_GAP}); argmax differs at "
            f"{int((~same & clear).sum())} of {n_clear} clear positions")
    argmax_differs = [[i, float(top2[i, 0] - top2[i, 1])]
                      for i in torch.nonzero(~same).flatten().tolist()]
    del full, ref, got_logits, decoded
    timing = time_xlstm(cfg, params, dev)
    gc.collect()
    torch.cuda.empty_cache()

    tk.reset_launch_counts()            # the training run's counts start here
    training = train_xlstm(cfg, params, dev)
    got = {n: c + got[n] for n, c in launch_counts().items()}
    if any(got.values()):
        raise AssertionError(f"xlstm: the codec ran on the serving or "
                             f"training path: {got}")
    report = {
        "model": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": n_params,
        "segments": [s._asdict() for s in causal_lm.segments(cfg)],
        "prompt": XLSTM_PROMPT, "new_tokens": XLSTM_NEW,
        "serve_s": serve_s, "tokens_per_s": XLSTM_NEW / serve_s,
        "decode_vs_forward": {
            "max_abs_gap": gap_abs, "rel_gap": gap,
            "clear_positions": n_clear,
            # positions (after the prompt) whose argmax differs, each with
            # the forward's top-2 margin: all below 10 times the gap
            "argmax_differs": argmax_differs},
        "allocated_before_gb": allocated / 1e9,
        "serve_peak_mem_gb": serve_peak / 1e9, "init_s": init_s,
        "timing": timing, "training": training, "launches": got}
    print("xlstm path: " + json.dumps(report))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    smoke = check_xlstm_smoke(dev)
    print(f"xlstm path: {XLSTM_NEW} greedy tokens, decode vs forward rel "
          f"gap {gap:.2e}, argmax equal at {n_clear} clear positions; "
          f"{XLSTM_TRAIN_STEPS} Adafactor steps, losses "
          f"{training['losses']}; smoke card vs CPU max rel "
          f"{max(smoke.values()):.2e}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return got


def check_xlstm_smoke(dev) -> dict:
    """xlstm-smoke (2 groups of one mLSTM + one sLSTM) and the same with 5
    layers, which adds an mlstm tail (a segment the full config never
    reaches), each with the same weights on the card and on the CPU: a
    prefill and 4 decode steps (both fed the CPU's greedy tokens)
    — the logits and every cache leaf, each leaf's largest gap over the
    CPU's largest |value| —, and one train step's loss and gradients
    (``loss_and_grad``; the gradient as one vector, its largest gap over its
    largest |value|, as a logits tensor is held), all within
    XLSTM_SMOKE_GAP.  Beside them it prints the gradient's worst leaf
    against a float64 run on the CPU, for the card and for the CPU's
    float32: how far float32 itself is from the exact gradient there.
    Returns the largest gap of each check."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.core.rad import tree_map
    from repro_torch.distributed.steps import loss_and_grad
    from repro_torch.models import causal_lm

    def rel(a, b):
        a = torch.cat([t.to(torch.float64).flatten() for t in a])
        b = torch.cat([t.to(torch.float64).flatten() for t in b])
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    def worst_leaf(a, b):
        return max(rel([x], [y]) for x, y in zip(a, b))

    cpu = torch.device("cpu")
    out = {}
    smoke = resolve(XLSTM_ARCH).smoke
    for cfg in (smoke, smoke.replace(name="xlstm-smoke-tail", n_layers=5)):
        params = causal_lm.init(cfg, torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (2, 17),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        sides = {}
        feed = None
        for side, d in (("cpu", cpu), ("card", dev)):
            p = tree_map(lambda t: t.to(d), params)
            logits, cache = causal_lm.prefill(cfg, p, toks[:, :8].to(d))
            steps, caches, fed = [logits], [cache], []
            for i in range(4):
                tok = (torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                       if feed is None else feed[i].to(d))
                fed.append(tok.cpu())
                logits, cache = causal_lm.decode_step(cfg, p, cache, tok)
                steps.append(logits)
                caches.append(cache)
            feed = fed
            loss, _, grads = loss_and_grad(
                cfg, p, {k: v.to(d) for k, v in batch.items()})
            sides[side] = {"serve": [t.cpu() for t in tree_leaves(
                               {"logits": steps, "caches": caches})],
                           "loss": [loss.cpu()],
                           "grads": [t.cpu() for t in tree_leaves(grads)]}
        cfg64 = cfg.replace(dtype=torch.float64, param_dtype=torch.float64)
        _, _, g64 = loss_and_grad(
            cfg64, tree_map(lambda t: t.to(torch.float64), params), batch)
        g64 = tree_leaves(g64)
        card, host = sides["card"], sides["cpu"]
        out[cfg.name] = {
            "serve": max(rel([a], [b]) for a, b in zip(card["serve"],
                                                       host["serve"])),
            "loss": rel(card["loss"], host["loss"]),
            "grads": rel(card["grads"], host["grads"]),
            "info_worst_grad_leaf_card_vs_float64":
                worst_leaf(card["grads"], g64),
            "info_worst_grad_leaf_cpu_vs_float64":
                worst_leaf(host["grads"], g64)}
    worst = {f"{n} {k}": v for n, g in out.items() for k, v in g.items()
             if not k.startswith("info")}
    if max(worst.values()) > XLSTM_SMOKE_GAP:
        raise AssertionError(f"xlstm smoke: card and CPU differ: {out}")
    print("xlstm smoke checks: " + json.dumps(
        {"max_rel_gap_card_cpu": out, "limit": XLSTM_SMOKE_GAP}))
    return worst


ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_PREFIX = 8           # target tokens the prefill takes
ENCDEC_CACHE_LEN = 512      # self-KV slots; the source is src_len_for(512)
ENCDEC_NEW = 128            # greedy decode steps
ENCDEC_GAP = 1e-3           # decode vs forward logits, rel to max |logit|
# timed prefills: (target tokens, cache_len); frames = src_len_for(cache_len)
ENCDEC_PREFILLS = ((ENCDEC_PREFIX, ENCDEC_CACHE_LEN), (512, 4096))
ENCDEC_TRAIN_STEPS = 3      # AdamW steps at full size
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 8, 256
ENCDEC_SMOKE_GAP = 1e-5     # seamless-smoke, its padded variant: card vs CPU
# 2 + 2 layers with a vocabulary padded past its true size (the smoke
# config pads nothing, so the head's -1e30 mask would go unexercised)
ENCDEC_SMOKE_PAD = dict(name="seamless-smoke-pad", n_layers=4,
                        n_enc_layers=2, vocab=500, vocab_pad_to=64)


def encdec_bound_ms(cfg, batch, src_len, tokens, cache_len, kv_len) -> dict:
    """Least time of one encoder-decoder serving call at ``batch`` from the
    config: a prefill (``tokens`` target tokens over ``src_len`` frames,
    caches of ``cache_len``) or a decode step (``tokens`` = 1, attending
    ``kv_len`` cached positions and ``src_len`` frames).  Bytes: the
    weights the call uses read once (a decode: the decoder blocks,
    ``final_norm`` and the head; a prefill: every weight but the embedding
    table), the embedding rows and frames read, the caches read (decode)
    or written (prefill) once, the new K/V rows and the last position's
    logits written.  Operations: the fp32 matmul work of these shapes (the
    prefill's causal scores at S(S+1)/2 pairs, the decode's K/V projected
    for the new token only, the cross K/V for no token: the prefill made
    them; logits for the last position only).  ``model_flops`` beside it is
    ``forward_flops``, the reference's whole-model accounting of a call of
    that batch and length, which takes the source length from the target
    length and counts logits at every position."""
    from repro_torch.analysis import forward_flops
    from repro_torch.models import encdec
    from repro_torch.models.layers import mlp_flops

    d, V, n_dec = cfg.d_model, cfg.vocab_padded, cfg.n_dec_layers
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    nrm = 2 * d
    attn_w = 2 * d * q + 2 * d * kv
    mlp_w = 2 * d * cfg.d_ff
    dec_w = n_dec * (2 * attn_w + mlp_w + 3 * nrm) + nrm + d * V
    self_kv = 2 * n_dec * batch * cache_len * kv
    cross_kv = 2 * n_dec * batch * src_len * kv
    T = batch * tokens
    decode = tokens == 1
    if decode:
        weights = dec_w
        nbytes = 4 * (weights + T * d + self_kv + cross_kv
                      + 2 * n_dec * T * kv + batch * V)
        attn_ops = (2 * T * d * (2 * q + 2 * kv)        # self q, k, v, o
                    + 4 * T * kv_len * q                 # self scores, mix
                    + 2 * T * d * 2 * q                  # cross q, o
                    + 4 * T * src_len * q)               # cross scores, mix
        ops = n_dec * (attn_ops + mlp_flops(T, d, cfg.d_ff, cfg.act))
        model = forward_flops(cfg, batch, 1, kv_len=kv_len, decode=True)
    else:
        weights = encdec.count_params(cfg) - V * d
        Ts = batch * src_len
        nbytes = 4 * (weights + T * d + Ts * cfg.d_frontend + self_kv
                      + cross_kv + batch * V)
        enc_ops = cfg.n_enc_layers * (
            2 * Ts * d * (2 * q + 2 * kv) + 4 * Ts * src_len * q
            + mlp_flops(Ts, d, cfg.d_ff, cfg.act))
        dec_ops = n_dec * (
            2 * T * d * (2 * q + 2 * kv)
            + 4 * batch * (tokens * (tokens + 1) // 2) * q
            + 2 * T * d * 2 * q + 2 * Ts * d * 2 * kv
            + 4 * T * src_len * q + mlp_flops(T, d, cfg.d_ff, cfg.act))
        ops = 2 * Ts * cfg.d_frontend * d + enc_ops + dec_ops
        model = forward_flops(cfg, batch, tokens)
    ops += 2 * batch * d * V                              # head
    ms = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
          "operations": 1e3 * ops / FP32_OPS_PER_S}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by, "bytes_ms": ms["bytes"],
            "operations_ms": ms["operations"], "weight_bytes": 4 * weights,
            "bytes": nbytes, "operations": ops, "model_flops": model,
            "model_flops_ms": 1e3 * model / FP32_OPS_PER_S}


def encdec_inputs(cfg, batch, src_len, tokens, seed):
    """Frame embeddings (batch, src_len, d_frontend) and target tokens
    (batch, tokens), drawn with numpy from ``seed``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((batch, src_len, cfg.d_frontend))
    toks = rng.integers(0, cfg.vocab, (batch, tokens))
    return (torch.from_numpy(src.astype(np.float32)),
            torch.from_numpy(toks.astype(np.int64)))


def greedy_next(logits):
    """The greedy next token (B, 1) of last-position logits (B, S, V)."""
    import torch
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]


def time_encdec(cfg, params, dev) -> dict:
    """seamless full through the step builders: ``decode_step`` at batch 1
    and 4 (against a cache from an ENCDEC_PREFIX-token prefill) and each
    prefill of ENCDEC_PREFILLS at batch 1: median and spread of
    SERVE_TIMING_REPS calls (CUDA events), the profiler's kernel time of
    one call, the bound, and the greedy tokens/s of the median decode
    step."""
    import statistics

    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step,
                                               src_len_for)

    decode = make_decode_step(cfg)

    def row(fn, batch, src_len, tokens, cache_len, kv_len):
        ms = event_times_ms(fn)
        out = {"median_ms": statistics.median(ms), "min_ms": min(ms),
               "max_ms": max(ms), "reps": len(ms),
               "kernel_ms": device_busy_ms(fn, reps=1)}
        out.update(encdec_bound_ms(cfg, batch, src_len, tokens, cache_len,
                                   kv_len))
        return out

    out = {}
    src_len = src_len_for(cfg, ENCDEC_CACHE_LEN)
    prefill = make_prefill_step(cfg, cache_len=ENCDEC_CACHE_LEN)
    for batch in (1, 4):
        src, prefix = encdec_inputs(cfg, batch, src_len, ENCDEC_PREFIX, 7)
        logits, cache = prefill(params, {"src_embeds": src.to(dev),
                                         "tokens": prefix.to(dev)})
        tok = greedy_next(logits)
        r = row(lambda: decode(params, cache, tok), batch, src_len, 1,
                ENCDEC_CACHE_LEN, ENCDEC_PREFIX + 1)
        r["greedy_tokens_per_s"] = 1e3 * batch / r["median_ms"]
        out[f"decode_b{batch}"] = r
        del logits, cache
    for tokens, cache_len in ENCDEC_PREFILLS:
        frames = src_len_for(cfg, cache_len)
        src, prefix = encdec_inputs(cfg, 1, frames, tokens, 8)
        batch = {"src_embeds": src.to(dev), "tokens": prefix.to(dev)}
        step = make_prefill_step(cfg, cache_len=cache_len)
        out[f"prefill_{frames}x{tokens}_b1"] = row(
            lambda: step(params, batch), 1, frames, tokens, cache_len, 0)
    return out


def train_encdec(cfg, params, dev) -> dict:
    """ENCDEC_TRAIN_STEPS steps of ``make_train_step(cfg, adamw(3e-4))``
    from ``params`` on ``SyntheticSeq2Seq`` data (seed 0: batch
    ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ target tokens over
    ``src_len_for(cfg, ENCDEC_TRAIN_SEQ)`` frames) through
    ``ShardedLoader``; step 1's loss is held against ``encdec.train_loss``
    on the same batch and weights (rel 1e-6), and every loss must be
    finite.  The FLOP bound is ``3 × forward_flops`` (the reference's
    training accounting) at the fp32 peak."""
    import torch
    from repro_torch.analysis import forward_flops
    from repro_torch.data import ShardedLoader, SyntheticSeq2Seq
    from repro_torch.distributed.steps import make_train_step, src_len_for
    from repro_torch.models import encdec
    from repro_torch.optim import adamw

    B, S = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ
    src_len = src_len_for(cfg, S)
    opt = adamw(3e-4)
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticSeq2Seq(vocab=cfg.vocab, src_len=src_len, tgt_len=S,
                          d_frontend=cfg.d_frontend, seed=0)
    loader = ShardedLoader((ds.batch(B, i) for i in range(ENCDEC_TRAIN_STEPS)),
                           dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = opt.init(params)
    losses, step_s, first_ref = [], [], None
    for i in range(ENCDEC_TRAIN_STEPS):
        batch = next(loader)
        if i == 0:
            with torch.no_grad():
                first_ref = float(encdec.train_loss(cfg, params, batch)[0])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated(dev)
    del ds, loader
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"encdec train: non-finite loss {losses}")
    rel = abs(losses[0] - first_ref) / abs(first_ref)
    if rel > 1e-6:
        raise AssertionError(f"encdec train: step 1's loss {losses[0]} vs "
                             f"train_loss {first_ref} (rel {rel:.3e})")
    steady = step_s[1:]
    flops = 3 * forward_flops(cfg, B, S)
    return {"batch": B, "target_len": S, "src_len": src_len,
            "optimizer": "adamw(3e-4)", "losses": losses,
            "train_loss_step1": first_ref, "step1_rel_gap": rel,
            "step_s": step_s, "steady_step_s": sum(steady) / len(steady),
            "target_tokens_per_s": B * S * len(steady) / sum(steady),
            "flop_bound_ms": 1e3 * flops / FP32_OPS_PER_S, "flops": flops,
            "peak_mem_gb": peak / 1e9}


def run_encdec_path(dev):
    """seamless-m4t-large-v2 full (12 encoder + 12 decoder layers, d_model
    1024, 16 heads, d_ff 8192, vocab 256,206 padded to 256,256; random
    weights from seed 0, fp32) served through ``steps.make_prefill_step`` /
    ``make_decode_step`` — ``src_len_for(cfg, ENCDEC_CACHE_LEN)`` frame
    embeddings and an ENCDEC_PREFIX-token target prefix at batch 1, then
    ENCDEC_NEW greedy tokens — and trained for ENCDEC_TRAIN_STEPS AdamW
    steps through ``make_train_step``, the codec's counts set to 0 just
    before each and read just after (neither runs the codec, as in JAX).
    A teacher-forced ``encdec._decoder_train`` over the prefix and the
    served tokens, on the same memory, holds the served logits (within
    ENCDEC_GAP of the largest |logit|, and the same argmax wherever the
    forward's top-2 margin is over 10 times the gap); the decode step and
    the prefills are timed beside their bound; then
    ``check_encdec_smoke``."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step,
                                               src_len_for)
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.models import encdec

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = resolve(ENCDEC_ARCH).full
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = encdec.init(cfg, gen)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t_phase
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != encdec.count_params(cfg):
        raise AssertionError(f"encdec: init drew {n_params} parameters, "
                             f"count_params says {encdec.count_params(cfg)}")
    src_len = src_len_for(cfg, ENCDEC_CACHE_LEN)
    src, prefix = encdec_inputs(cfg, 1, src_len, ENCDEC_PREFIX, 0)
    src, prefix = src.to(dev), prefix.to(dev)
    prefill = make_prefill_step(cfg, cache_len=ENCDEC_CACHE_LEN)
    decode = make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)

    tk.reset_launch_counts()            # the serving run's counts start here
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"src_embeds": src, "tokens": prefix})
    served, tokens = [logits[:, -1, :]], []
    for _ in range(ENCDEC_NEW):
        tok = greedy_next(logits)
        tokens.append(tok)
        logits, cache = decode(params, cache, tok)
        served.append(logits[:, -1, :])
    torch.cuda.synchronize(dev)
    serve_s = time.perf_counter() - t0
    got = launch_counts()
    serve_peak = torch.cuda.max_memory_allocated(dev)
    if int(cache["pos"]) != ENCDEC_PREFIX + ENCDEC_NEW:
        raise AssertionError(f"encdec: cache at {int(cache['pos'])}")
    del cache

    seq = torch.cat([prefix] + tokens, dim=1)
    with torch.inference_mode():
        memory = encdec.encode(cfg, params, src)
        full = encdec._decoder_train(cfg, params, seq, memory)
    # the prefill's last position and every decoded one, over the true
    # vocabulary (not the -1e30 pad)
    ref = full[0, ENCDEC_PREFIX - 1:, :cfg.vocab]
    got_logits = torch.cat(served)[:, :cfg.vocab]
    if not (torch.isfinite(got_logits).all() and torch.isfinite(ref).all()):
        raise AssertionError("encdec: non-finite logits")
    gap_abs = float((got_logits - ref).abs().max())
    gap = gap_abs / float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 10 * gap_abs
    same = torch.argmax(got_logits, -1) == torch.argmax(ref, -1)
    n_clear = int(clear.sum())
    if gap > ENCDEC_GAP or not bool(same[clear].all()):
        raise AssertionError(
            f"encdec: served vs teacher-forced rel gap {gap:.3e} (limit "
            f"{ENCDEC_GAP}); argmax differs at "
            f"{int((~same & clear).sum())} of {n_clear} clear positions")
    argmax_differs = [[i, float(top2[i, 0] - top2[i, 1])]
                      for i in torch.nonzero(~same).flatten().tolist()]
    del full, ref, got_logits, served, memory
    timing = time_encdec(cfg, params, dev)
    gc.collect()
    torch.cuda.empty_cache()

    tk.reset_launch_counts()            # the training run's counts start here
    training = train_encdec(cfg, params, dev)
    got = {n: c + got[n] for n, c in launch_counts().items()}
    if any(got.values()):
        raise AssertionError(f"encdec: the codec ran on the serving or "
                             f"training path: {got}")
    report = {
        "model": cfg.name, "n_enc_layers": cfg.n_enc_layers,
        "n_dec_layers": cfg.n_dec_layers, "d_model": cfg.d_model,
        "params": n_params, "src_frames": src_len, "prefix": ENCDEC_PREFIX,
        "cache_len": ENCDEC_CACHE_LEN, "new_tokens": ENCDEC_NEW,
        "serve_s": serve_s, "tokens_per_s": ENCDEC_NEW / serve_s,
        "served_vs_teacher_forced": {
            "max_abs_gap": gap_abs, "rel_gap": gap,
            "positions": len(same), "clear_positions": n_clear,
            # positions (from the prefill's last) whose argmax differs, each
            # with the forward's top-2 margin: all below 10 times the gap
            "argmax_differs": argmax_differs},
        "allocated_before_gb": allocated / 1e9,
        "serve_peak_mem_gb": serve_peak / 1e9, "init_s": init_s,
        "timing": timing, "training": training, "launches": got}
    print("encdec path: " + json.dumps(report))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    smoke = check_encdec_smoke(dev)
    print(f"encdec path: {ENCDEC_NEW} greedy tokens, served vs "
          f"teacher-forced rel gap {gap:.2e}, argmax equal at {n_clear} "
          f"clear positions; {ENCDEC_TRAIN_STEPS} AdamW steps, losses "
          f"{training['losses']}; smoke card vs CPU max rel "
          f"{max(smoke.values()):.2e}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return got


def check_encdec_smoke(dev) -> dict:
    """seamless-smoke (one layer a side) and ENCDEC_SMOKE_PAD (two a side,
    a padded vocabulary), each with the same weights on the card and on
    the CPU: a prefill and 4 decode steps (both fed the CPU's greedy
    tokens) — the logits and every cache leaf, each leaf's largest gap
    over the CPU's largest |value| —, and one train step's loss and
    gradients (``loss_and_grad``; the gradient as one vector), all within
    ENCDEC_SMOKE_GAP.  Returns the largest gap of each check."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.opgraph import tree_leaves
    from repro_torch.core.rad import tree_map
    from repro_torch.distributed.steps import loss_and_grad
    from repro_torch.models import encdec

    def rel(a, b):
        a = torch.cat([t.to(torch.float64).flatten() for t in a])
        b = torch.cat([t.to(torch.float64).flatten() for t in b])
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    cpu = torch.device("cpu")
    out = {}
    smoke = resolve(ENCDEC_ARCH).smoke
    for cfg in (smoke, smoke.replace(**ENCDEC_SMOKE_PAD)):
        params = encdec.init(cfg, torch.Generator().manual_seed(0))
        src, toks = encdec_inputs(cfg, 2, 16, 17, 1)
        batch = {"src_embeds": src, "tokens": toks[:, :-1],
                 "labels": toks[:, 1:]}
        sides, feed = {}, None
        for side, d in (("cpu", cpu), ("card", dev)):
            p = tree_map(lambda t: t.to(d), params)
            logits, cache = encdec.prefill(cfg, p, src.to(d),
                                           toks[:, :8].to(d), 16)
            steps, caches, fed = [logits], [cache], []
            for i in range(4):
                tok = (greedy_next(logits) if feed is None
                       else feed[i].to(d))
                fed.append(tok.cpu())
                logits, cache = encdec.decode_step(cfg, p, cache, tok)
                steps.append(logits)
                caches.append(cache)
            feed = fed
            loss, _, grads = loss_and_grad(
                cfg, p, {k: v.to(d) for k, v in batch.items()})
            sides[side] = {"serve": [t.cpu() for t in tree_leaves(
                               {"logits": steps, "caches": caches})],
                           "loss": [loss.cpu()],
                           "grads": [t.cpu() for t in tree_leaves(grads)]}
        card, host = sides["card"], sides["cpu"]
        out[cfg.name] = {
            "serve": max(rel([a], [b]) for a, b in zip(card["serve"],
                                                       host["serve"])),
            "loss": rel(card["loss"], host["loss"]),
            "grads": rel(card["grads"], host["grads"])}
    worst = {f"{n} {k}": v for n, g in out.items() for k, v in g.items()}
    if max(worst.values()) > ENCDEC_SMOKE_GAP:
        raise AssertionError(f"encdec smoke: card and CPU differ: {out}")
    print("encdec smoke checks: " + json.dumps(
        {"max_rel_gap_card_cpu": out, "limit": ENCDEC_SMOKE_GAP}))
    return worst


PIPE_MICRO = 4              # GPipe micro-batches: 2 sequences each
PIPE_STEPS = 4              # AdamW steps at base ratio 10
PIPE_BASE_RATIOS = (1.0, 10.0)  # Eq. 7's pod edge 3r: k 1,366 / 137 a block
PIPE_GSPMD_STEPS = 3        # gspmd steps beside it, same weights and state
PIPE_LOSS_GAP = 1e-6        # uncompressed pipeline vs autograd, loss, rel
PIPE_GRAD_GAP = 1e-5        # ... gradients as one vector, rel
PIPE_SMOKE_GAP = 1e-5       # smoke pipeline, card vs CPU, rel


def vector_gap(a_tree, b_tree) -> float:
    """|a - b| / |b| over every leaf of two trees as one vector (float64
    sums)."""
    from repro_torch.core.opgraph import tree_leaves
    num = den = 0.0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        d = a.double() - b.to(a.device).double()
        num += float((d * d).sum())
        den += float((b.double() * b.double()).sum())
    return math.sqrt(num / den)


def step_device_ms(fn) -> dict:
    """One call of ``fn`` under the profiler (CUDA activity): the summed
    kernel time, and the time and launches of the codec's encode and
    decode kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"device_ms": 0.0, "encode_ms": 0.0, "encode_launches": 0,
           "decode_ms": 0.0, "decode_launches": 0}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        out["device_ms"] += t
        for part in ("encode", "decode"):
            if f"{part}_kernel" in ev.key:
                out[f"{part}_ms"] += t
                out[f"{part}_launches"] += ev.count
    out["codec_ms"] = out["encode_ms"] + out["decode_ms"]
    out["codec_launches"] = out["encode_launches"] + out["decode_launches"]
    return out


def run_pipeline_path(dev):
    """gpt2-xl full (48 layers, d_model 1600; seed 0, fp32, TF32 off)
    through the GPipe pipeline (``distributed.pipeline``), batch BATCH ×
    SEQ of ``SyntheticLM`` in PIPE_MICRO micro-batches, every mesh
    position on this card:

    1. the ``(8,)`` ``("model",)`` mesh (no compression): loss and
       gradients against ``make_train_step``'s autograd (``loss_and_grad``)
       on the same weights and batch, within PIPE_LOSS_GAP / PIPE_GRAD_GAP;
    2. the ``(2, 4)`` ``("pod", "model")`` mesh with ``use_kernel="auto"``:
       one loss and gradient at base ratio 1 (edge 3 -> 4 at ratio 3), then
       PIPE_STEPS AdamW(3e-4) steps at base ratio 10 (ratio 30), composed
       as ``make_pipeline_train_step`` composes them, and one more step
       under the profiler (the codec's share of the step's kernel time);
       every call must launch 8 encodes and 8 decodes (4 micro-batches,
       forward and backward, on one edge);
    3. PIPE_GSPMD_STEPS steps of ``make_train_step`` from the same weights
       and AdamW state, timed the same way: the gspmd step beside it.

    The codec's counts are set to 0 just before 1 and read after 2.
    Returns (launch counts, the codec's (shape, k a block) cases)."""
    import torch
    from repro_torch.analysis import model_flops
    from repro_torch.analysis.roofline import HW, roofline_terms
    from repro_torch.configs import InputShape, resolve
    from repro_torch.core.compression import ratio_to_k
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.distributed.steps import (loss_and_grad, make_train_step,
                                               value_and_grad)
    from repro_torch.kernels import ops, topk_compress as tk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import causal_lm
    from repro_torch.optim import adamw

    gc.collect()
    torch.cuda.empty_cache()
    cfg = resolve("gpt2-xl").full
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = causal_lm.init(cfg, gen)
    n_params = causal_lm.count_params(cfg)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0, order=1)

    def batch_at(i):
        return {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in ds.batch(BATCH, i).items()}

    codec = ("encode_topk", "decode_topk")
    expect = {n: 8 if n in codec else 0 for n in tk.KERNELS}

    def delta(before):
        now = launch_counts()
        return {n: now[n] - before[n] for n in now}

    batch = batch_at(0)
    tk.reset_launch_counts()            # this path's counts start here
    flat = make_mesh((8,), ("model",), [dev] * 8)
    fn = pipe.make_pipeline_train_fn(cfg, flat, PIPE_MICRO)
    mb = pipe.microbatch(batch, PIPE_MICRO)
    loss_p, g_p = value_and_grad(lambda p: fn(p, mb), params)
    loss_r, _, g_r = loss_and_grad(cfg, params, batch)
    loss_gap = abs(float(loss_p) - float(loss_r)) / abs(float(loss_r))
    grad_gap = vector_gap(g_p, g_r)
    del g_p, g_r
    if any(launch_counts().values()):
        raise AssertionError(f"pipeline: the uncompressed mesh ran the "
                             f"codec: {launch_counts()}")
    if loss_gap > PIPE_LOSS_GAP or grad_gap > PIPE_GRAD_GAP:
        raise AssertionError(f"pipeline: uncompressed vs autograd: loss "
                             f"{float(loss_p)} vs {float(loss_r)} (rel "
                             f"{loss_gap:.3e}), gradients rel {grad_gap:.3e}")

    pod = make_mesh((2, 4), ("pod", "model"), [dev] * 8)
    n = BATCH // PIPE_MICRO * SEQ * cfg.d_model
    shape = (BATCH // PIPE_MICRO, SEQ, cfg.d_model)
    cases, ks = set(), {}
    for base in PIPE_BASE_RATIOS:
        ratio = float(pipe.pod_edge_ratios(pod, base).max())
        ks[base] = ops.per_block_k(n, ratio_to_k(n, ratio))
        cases.add((shape, ks[base]))
    fns = {base: pipe.make_pipeline_train_fn(cfg, pod, PIPE_MICRO, base,
                                             use_kernel="auto")
           for base in PIPE_BASE_RATIOS}
    c0 = launch_counts()
    loss_1, g_1 = value_and_grad(lambda p: fns[1.0](p, mb), params)
    del g_1
    if delta(c0) != expect or not math.isfinite(float(loss_1)):
        raise AssertionError(f"pipeline base ratio 1: launches "
                             f"{delta(c0)}, expected {expect}; loss "
                             f"{float(loss_1)}")

    opt = adamw(3e-4)
    state = opt.init(params)
    loss_fn = fns[10.0]

    def step(params, state, mb):
        loss, grads = value_and_grad(lambda p: loss_fn(p, mb), params)
        params, state = opt.update(grads, state, params)
        return params, state, loss

    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    for i in range(PIPE_STEPS):
        mb = pipe.microbatch(batch_at(i), PIPE_MICRO)
        c0 = launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, mb)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if delta(c0) != expect:
            raise AssertionError(f"pipeline step {i}: launches "
                                 f"{delta(c0)}, expected {expect}")
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pipeline: non-finite loss {losses}")
    mb = pipe.microbatch(batch_at(PIPE_STEPS), PIPE_MICRO)
    c0 = launch_counts()
    held = {}

    def profiled():
        held["out"] = step(params, state, mb)

    prof = step_device_ms(profiled)
    params, state, _ = held.pop("out")
    if delta(c0) != expect or prof["codec_launches"] not in (0, 16):
        raise AssertionError(f"pipeline profiled step: launches "
                             f"{delta(c0)}, profiler {prof}")
    got = launch_counts()

    gspmd = make_train_step(cfg, opt)
    gspmd_s = []
    for i in range(PIPE_GSPMD_STEPS):
        b = batch_at(PIPE_STEPS + 1 + i)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, _ = gspmd(params, state, b)
        torch.cuda.synchronize(dev)
        gspmd_s.append(time.perf_counter() - t0)

    steady = step_s[1:]
    flops = model_flops(cfg, InputShape("pipeline", SEQ, BATCH, "train"))
    # the update reads parameters, gradients and both moments and writes
    # parameters and moments, once each; the hand-offs stay on the card
    bound = roofline_terms(flops, 7 * 4 * n_params, 0.0, hw=HW.fp32())
    report = {
        "card": card_line(),
        "mesh": "(2, 4) pod x model on one card", "micro_batches": PIPE_MICRO,
        "micro_batch": BATCH // PIPE_MICRO, "seq": SEQ,
        "uncompressed": {"loss": float(loss_p), "autograd_loss":
                         float(loss_r), "loss_rel_gap": loss_gap,
                         "grad_rel_gap": grad_gap},
        "base_ratio_1_loss": float(loss_1),
        "k_per_block": {str(b): k for b, k in ks.items()},
        "losses": losses, "step_s": step_s,
        "steady_step_s": sum(steady) / len(steady),
        "tokens_per_s": BATCH * SEQ * len(steady) / sum(steady),
        "peak_mem_gb": peak / 1e9,
        "profiled_step": {**prof, "codec_share_of_device": (
            prof["codec_ms"] / prof["device_ms"] if prof["device_ms"]
            else None)},
        "flops": flops, "flop_bound_ms": 1e3 * bound.bound_time,
        "bound_by": bound.dominant,
        "gspmd_step_s": gspmd_s,
        "gspmd_steady_step_s": sum(gspmd_s[1:]) / len(gspmd_s[1:]),
        "launches": got}
    print("pipeline path: " + json.dumps(report))
    del params, state, gspmd
    gc.collect()
    torch.cuda.empty_cache()
    return got, cases


def check_pipeline_smoke(dev) -> dict:
    """The reference test's sizes (gpt2-smoke with 8 layers, batch 8 × seq
    32, 4 micro-batches), the same weights on the card and on the CPU: on
    the ``(8,)`` model mesh the loss and the gradients (one vector), on the
    ``(2, 4)`` pod mesh at base ratio 10 with ``use_kernel="auto"`` (the
    CUDA kernels on the card, their plain versions on the CPU) the loss,
    all within PIPE_SMOKE_GAP."""
    import torch
    from repro_torch.configs import resolve
    from repro_torch.core.rad import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.distributed.steps import value_and_grad
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import causal_lm

    cfg = resolve("gpt2-xl").smoke.replace(n_layers=8, max_seq=32)
    params = causal_lm.init(cfg, torch.Generator().manual_seed(0))
    raw = SyntheticLM(vocab=cfg.vocab, seq_len=32, seed=1, order=1).batch(8, 0)
    out = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = tree_map(lambda t: t.to(d), params)
        mb = pipe.microbatch({k: torch.as_tensor(v, dtype=torch.long,
                                                 device=d)
                              for k, v in raw.items()}, PIPE_MICRO)
        flat = make_mesh((8,), ("model",), [d] * 8)
        pod = make_mesh((2, 4), ("pod", "model"), [d] * 8)
        fn = pipe.make_pipeline_train_fn(cfg, flat, PIPE_MICRO)
        loss, grads = value_and_grad(lambda q: fn(q, mb), p)
        with torch.no_grad():
            comp = pipe.make_pipeline_train_fn(cfg, pod, PIPE_MICRO, 10.0,
                                               use_kernel="auto")(p, mb)
        out[side] = (float(loss), grads, float(comp))
    (lc, gc_, cc), (lx, gx, cx) = out["card"], out["cpu"]
    gaps = {"loss": abs(lc - lx) / abs(lx), "grads": vector_gap(gc_, gx),
            "compressed_loss": abs(cc - cx) / abs(cx)}
    if max(gaps.values()) > PIPE_SMOKE_GAP:
        raise AssertionError(f"pipeline smoke: card and CPU differ: {gaps} "
                             f"(losses card {lc}, {cc}; cpu {lx}, {cx})")
    print("pipeline smoke checks: " + json.dumps(
        {"max_rel_gap_card_cpu": gaps, "limit": PIPE_SMOKE_GAP,
         "losses": {"card": [lc, cc], "cpu": [lx, cx]}}))
    return gaps


# =============================================== analysis, checks, dry run ==
SIM_BUSY = ("sim_device_busy_seconds", "sim_link_busy_seconds",
            "sim_compress_busy_seconds")
ANALYSIS_DIR = ROOT / "build" / "analysis"


def run_module(args, timeout: float) -> tuple:
    """``python -m <args>`` from the checkout with the port on the path:
    (exit code, seconds, standard output, standard error)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return (out.returncode, time.perf_counter() - t0, out.stdout.strip(),
            out.stderr.strip())


def check_analysis(traced: dict, card: str) -> dict:
    """The slice's analyzers over the gpt2-xl elastic trace: the trace as
    JSONL through ``python -m repro_torch.obs.export --validate
    --check-order`` and ``python -m repro_torch.obs.critpath
    --expect-busy`` (rc 0 each), ``traceorder.check_trace_order`` (no
    error), ``critpath.analyze`` + ``audit`` (every attempt's critical
    path covers its makespan) and ``check_sim_busy`` against the
    controller's counters (no problem); each attempt's makespan must equal
    its step record's simulated seconds, and the failure epoch's window
    re-priced by ``whatif.Scenario`` must equal its recorded step.  Then
    tracing must change no simulated number: the same controller,
    timing-only, with and without the kit, gives the same step and epoch
    records, and those of the trained run.  Prints the blame table's top
    rows, the what-if ranking over the failure window and the length of
    each section of ``report``; raises on any failure."""
    from repro_torch.check.traceorder import check_trace_order
    from repro_torch.core.costmodel import EdgeCostModel
    from repro_torch.elastic import ElasticController
    from repro_torch.obs import (FlightRecorder, MetricsRegistry,
                                 TraceRecorder, Watchdog, critpath, report,
                                 whatif)
    from repro_torch.obs.export import write_jsonl

    t0 = time.perf_counter()
    events = traced["events"]
    ANALYSIS_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = ANALYSIS_DIR / "TRACE_elastic.jsonl"
    metrics_path = ANALYSIS_DIR / "METRICS_elastic.json"
    n_written = write_jsonl(traced["recorder"], str(trace_path))
    metrics_path.write_text(json.dumps(traced["metrics"]))
    if traced["recorder"].n_dropped or n_written != len(events):
        raise AssertionError(f"analysis: the recorder dropped "
                             f"{traced['recorder'].n_dropped} events")
    clocks = dict(collections.Counter(e.clock for e in events))
    cli = {}
    for name, args in (
            ("export", ["repro_torch.obs.export", "--validate",
                        "--check-order", str(trace_path)]),
            ("critpath", ["repro_torch.obs.critpath", str(trace_path),
                          "--expect-busy", str(metrics_path), "--top",
                          "3"])):
        rc, secs, text, err = run_module(args, timeout=300)
        if rc != 0:
            raise AssertionError(f"analysis: {' '.join(args)} gave rc "
                                 f"{rc}:\n{text}\n{err}")
        cli[name] = {"rc": rc, "s": secs, "last_line": text.splitlines()[-1]}

    order = [f for f in check_trace_order(events) if f.severity == "error"]
    if order:
        raise AssertionError(f"analysis: happens-before errors {order[:5]}")
    decomps = critpath.analyze(events)
    audit = critpath.audit(decomps)
    busy = critpath.busy_accounting(events)
    totals = {k: traced["metrics"][k] for k in SIM_BUSY
              if k in traced["metrics"]}
    gate = critpath.check_sim_busy(busy, totals)
    if not decomps or audit or gate or "sim_device_busy_seconds" \
            not in totals:
        raise AssertionError(f"analysis: {len(decomps)} attempts, audit "
                             f"{audit}, busy gate {gate}, counters "
                             f"{totals}")
    # one attempt (data step, epoch stamp) for each executed step, in
    # execution order: the trace stamps 0-based data steps, the step
    # records count from 1
    executed = traced["steps"]
    attempts = sorted(decomps, key=lambda d: (d.attempt[1], d.attempt[0]))
    if len(attempts) != len(executed):
        raise AssertionError(f"analysis: {len(attempts)} attempts for "
                             f"{len(executed)} executed steps")
    for d, r in zip(attempts, executed):
        if d.attempt[0] != r["step"] - 1 or abs(
                d.makespan - r["step_seconds"]) > 1e-9 * r["step_seconds"]:
            raise AssertionError(f"analysis: attempt {d.attempt} makespan "
                                 f"{d.makespan} vs step record {r}")
    fail = next(e for e in traced["epochs"] if e["cause"] == "failure")
    window = [d for d, r in zip(attempts, executed)
              if r["epoch"] == fail["epoch"]]
    window_steps = [r for r in executed if r["epoch"] == fail["epoch"]]
    if not window:
        raise AssertionError("analysis: no attempt in the failure epoch")
    rows = critpath.blame(decomps)
    win_rows = critpath.blame(window)
    kc = traced["kernel_costs"]
    sc = whatif.Scenario(
        graph=traced["graph"], profiles=traced["profiles"],
        schedule=traced["schedule"], cluster=traced["true_cluster"],
        plan=traced["plan"], n_micro=2,
        cost_model=EdgeCostModel(traced["graph"], traced["profiles"],
                                 traced["true_cluster"], traced["plan"],
                                 kernel_costs=kc) if kc else None)
    base = sc.price()
    if abs(base - window_steps[-1]["step_seconds"]) > 1e-9 * base:
        raise AssertionError(f"analysis: the failure window re-priced at "
                             f"{base} s, recorded "
                             f"{window_steps[-1]['step_seconds']} s")
    ranked = whatif.rank(sc, whatif.default_interventions(sc, win_rows))
    text = report.build_report(events, traced["flight"], width=100)
    sections = {}
    for block in text.split("\n== "):
        head, _, body = block.lstrip("= ").partition("\n")
        sections[head.split(" ==")[0].strip()] = len(body.splitlines())
    if len(sections) != 7 or any(n == 0 for n in sections.values()):
        raise AssertionError(f"analysis: report sections {sections}")
    analysis_s = time.perf_counter() - t0

    # tracing changes no simulated number
    t1 = time.perf_counter()

    def timing_only(kit):
        ctrl = ElasticController(
            traced["graph"], traced["profiles"], traced["cluster"],
            traced["churn"], n_micro=2, lease_s=traced["lease_s"],
            migration_mode="stop", planner="joint",
            joint_ratio=ELASTIC_RATIO,
            use_kernel="auto", checkpoint_interval=3, checkpoint_history=2,
            device="cpu", **kit)
        res = ctrl.run(steps=ELASTIC_STEPS)
        steps = [dataclasses.asdict(r) for r in res.steps]
        for r in steps:
            r.pop("loss")
        return steps, [dataclasses.asdict(e) for e in res.epochs], \
            res.total_seconds

    kit = dict(tracer=TraceRecorder(), flight=FlightRecorder(),
               metrics=MetricsRegistry(), watchdog=Watchdog())
    plain, with_kit = timing_only({}), timing_only(kit)
    trained = ([{k: v for k, v in r.items() if k != "loss"}
                for r in traced["steps"]], traced["epochs"],
               traced["total_seconds"])
    if not plain == with_kit == trained:
        raise AssertionError("analysis: tracing changed the simulated "
                             "records (timing-only with / without the kit, "
                             "and the trained run)")
    sim_events = [e for e in kit["tracer"].events() if e.clock == "sim"]
    if critpath.busy_accounting(sim_events) != busy:
        raise AssertionError("analysis: the timing-only run's trace differs "
                             "from the trained run's on the sim clock")
    sim_check_s = time.perf_counter() - t1

    print("analysis blame (all attempts):\n"
          + critpath.render_blame(rows, top=5))
    print("analysis blame (failure window):\n"
          + critpath.render_blame(win_rows, top=5))
    out = {
        "card": card, "events": len(events), "by_clock": clocks,
        "attempts": len(decomps), "failure_window_attempts": len(window),
        "critical_share_by_kind": {
            kind: sum(r.share for r in rows if r.kind == kind)
            for kind in ("compute", "wire", "codec", "stall")},
        "mean_makespan_s": sum(d.makespan for d in decomps) / len(decomps),
        "busy_s": busy, "sim_busy_s": totals,
        "watchdog_trips": traced["watchdog_trips"],
        "flight_records": len(traced["flight"]),
        "whatif_baseline_s": base,
        "whatif": [{"name": r.name, "predicted_s": r.predicted_seconds,
                    "speedup": r.speedup} for r in ranked],
        "report_lines": sections, "cli": cli, "analysis_s": analysis_s,
        "timing_only_check_s": sim_check_s,
        "elastic_wall_s": traced["wall_s"]}
    print("analysis: " + json.dumps(out))
    return out


def run_check_package(card: str) -> dict:
    """``python -m repro_torch.check --all-configs --lint --docs`` in a
    subprocess: every arch's smoke OP-DAG planned and checked, the port's
    lint and the docs' links; rc 0."""
    args = ["repro_torch.check", "--all-configs", "--lint", "--docs"]
    rc, secs, text, err = run_module(args, timeout=600)
    lines = text.splitlines()
    if rc != 0 or not all(ln.endswith(": OK") for ln in lines):
        raise AssertionError(f"check: python -m {' '.join(args)} gave rc "
                             f"{rc}:\n{text}\n{err}")
    out = {"card": card, "rc": rc, "s": secs, "lines": len(lines)}
    print("check package: " + json.dumps(out))
    return out


def argument_bytes_by_leaves(args, in_shardings) -> int:
    """Per-device argument bytes, leaf by leaf in tree order (the dry
    run's own sum pairs leaves by path)."""
    from repro_torch.core.opgraph import tree_leaves
    leaves, shardings = tree_leaves(args), tree_leaves(in_shardings)
    if len(leaves) != len(shardings):
        raise AssertionError(f"dryrun: {len(leaves)} arguments for "
                             f"{len(shardings)} shardings")
    return sum(math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
               for t, sh in zip(leaves, shardings))


def run_dryrun_path(card: str) -> dict:
    """``dryrun.run_one`` for every arch × shape of the registry on both
    production meshes, in bf16: each record ``ok`` (``skipped`` where the
    registry skips the shape), its compiler-only fields ``None``, and its
    ``argument_bytes`` equal to the sum this phase takes again over the
    shardings ``build_jitted`` gives.  Nothing is allocated on any
    device.  Prints the argument GiB per device, by arch and shape, on
    16×16 and 2×16×16."""
    import torch
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, resolve
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.distributed.steps import build_jitted
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    gib, counts = {}, {"ok": 0, "skipped": 0}
    for arch in ARCH_IDS:
        entry = resolve(arch)
        for shape_name, shape in INPUT_SHAPES.items():
            for multi_pod in (False, True):
                rec = dryrun.run_one(arch, shape_name, multi_pod)
                want = "ok" if shape_name in entry.shapes else "skipped"
                if rec["status"] != want:
                    raise AssertionError(f"dryrun {arch} {shape_name} "
                                         f"multi_pod={multi_pod}: {rec}")
                counts[want] += 1
                if want == "skipped":
                    continue
                set_fields = [f for f in dryrun.NOT_MEASURED if (
                    rec["mem"] if f.startswith("mem.") else rec)[
                        f.split(".")[-1]] is not None]
                if set_fields:
                    raise AssertionError(f"dryrun {arch} {shape_name}: "
                                         f"compiler-only {set_fields} set")
                cfg = entry.full.replace(dtype=torch.bfloat16,
                                         param_dtype=torch.bfloat16,
                                         remat=shape.kind == "train")
                mesh = make_production_mesh(multi_pod=multi_pod)
                rules = {"batch": None} \
                    if shape.global_batch < mesh.shape["data"] else {}
                with use_mesh(mesh, rules):
                    _, args, meta = build_jitted(cfg, mesh, shape)
                want_bytes = argument_bytes_by_leaves(args,
                                                      meta["in_shardings"])
                if rec["mem"]["argument_bytes"] != want_bytes:
                    raise AssertionError(
                        f"dryrun {arch} {shape_name} {rec['mesh']}: "
                        f"argument_bytes {rec['mem']['argument_bytes']} vs "
                        f"{want_bytes} over the shardings")
                gib.setdefault(arch, {}).setdefault(shape_name, {})[
                    rec["mesh"]] = want_bytes / 2**30
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError("dryrun: the sweep allocated on the card")
    secs = time.perf_counter() - t0
    for arch, by_shape in gib.items():
        print(f"dryrun {arch}: argument GiB per device "
              + json.dumps(by_shape))
    out = {"card": card, "records": counts, "s": secs}
    print("dryrun path: " + json.dumps(out))
    return out


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
    paths["train elastic"], elastic_cases, elastic_trace = \
        run_elastic_path(dev)
    paths["serve"] = run_serve_path(dev)
    paths["serve hybrid"] = run_hybrid_serve_path(dev)
    paths["xlstm"] = run_xlstm_path(dev)
    paths["encdec"] = run_encdec_path(dev)
    paths["entry points"] = run_entry_points(dev)
    paths["train pipeline"], pipeline_cases = run_pipeline_path(dev)
    launches = {n: sum(p[n] for p in paths.values()) for n in tk.KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{launches}")
    if not elastic_cases or not cases:
        raise AssertionError("a training path ran no compressed boundary")
    for name, e in check_path_cases(
            dev, cases | elastic_cases | pipeline_cases).items():
        err[name] = max(err[name], e)
    check_against_reference(dev)
    check_gspmd_smoke(dev)
    check_elastic_smoke(dev)
    check_serve_smoke(dev)
    check_hybrid_smoke(dev)
    check_pipeline_smoke(dev)
    check_analysis(elastic_trace, card)
    del elastic_trace
    run_check_package(card)
    run_dryrun_path(card)

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
