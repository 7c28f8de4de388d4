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
6. drives the error-feedback and dense entry points (``ef_compress``,
   ``ops.topk_mask``, ``ops.ef_topk``) over 5 steps with the residual
   carried, counting their launches, and holds ``ef_compress`` bit-exact
   against the EF training step's own composition on the card and against
   the CPU's plain version;
7. checks the output the repository's way: finite losses, RAD equal to
   single-device autograd on the card at smoke size, and the card's loss
   curves (plain and error-feedback) against the CPU's on the same weights.

Every phase raises on failure (exit code 1).  Without a CUDA device it
exits with code 2 and prints no result.  The last line of standard output
is ``{"ok": true, "device": {...}}``.
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


def main() -> int:
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
    paths = {f"train {label}": r["launches"]
             for label, r in run_training_path(dev).items()}
    paths["entry points"] = run_entry_points(dev)
    check_against_reference(dev)
    launches = {n: sum(p[n] for p in paths.values()) for n in tk.KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{launches}")

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
