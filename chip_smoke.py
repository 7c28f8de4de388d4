#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the wire-codec kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc (into ``build/``);
3. holds each kernel bit-exact against its plain PyTorch version on the
   card: fp32/bf16/fp16, ragged sizes, all zeros, heavy ties, k = 1 and
   k = 4096, and the training path's boundary shapes;
4. times each kernel with CUDA events at the path's boundary shape, beside
   its plain version, its memory bound and ``torch.topk`` (selection only);
5. drives the port's training path — gpt2-xl at full width and depth,
   batch 8, seq 128, paper testbed 1, ``DecentralizedRuntime(use_kernel=
   "auto")`` — for a few AdamW steps under the uniform (ratio 100) and the
   AdaTopK plan, with launch counters set to 0 just before and read just
   after, and checks them against the plan's compressed-message count;
6. checks the output the repository's way: finite losses, RAD equal to
   single-device autograd on the card at smoke size, and the card's loss
   curve against the CPU's on the same weights.

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
REPLACES = {"encode_topk": "src/repro/kernels/topk_compress.py:228",
            "decode_topk": "src/repro/kernels/topk_compress.py:279"}


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


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.to(torch.float32).view(torch.int32),
                           b.to(torch.float32).view(torch.int32))
    return torch.equal(a, b)


def check_kernels(dev):
    """Every case bit-exact; returns the max |kernel - plain| per kernel."""
    import torch
    from repro_torch.kernels import ref, topk_compress as tk

    gen = torch.Generator().manual_seed(0)
    levels = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])
    cases = [((64,), 1, 512, "normal"), ((5000,), 40, 512, "normal"),
             ((1000,), 5, 512, "zeros"), ((3000,), 9, 512, "ties"),
             ((9000,), 1, 4096, "ties"), ((9000,), 4096, 4096, "normal"),
             ((4097,), 4096, 4096, "zeros"), ((33, 1001), 17, 4096, "normal"),
             ((BATCH, SEQ, 1600), 41, 4096, "normal"),
             ((BATCH, SEQ, 50432), 41, 4096, "normal")]
    err = {"encode_topk": 0.0, "decode_topk": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for shape, k, block, regime in cases:
            n = math.prod(shape)
            if regime == "zeros":
                x = torch.zeros(n)
            elif regime == "ties":
                x = levels[torch.randint(0, 5, (n,), generator=gen)]
            else:
                x = torch.randn(n, generator=gen)
            x = x.reshape(shape).to(dtype).to(dev)
            v, m = tk.encode_topk(x, k, block)
            d = tk.decode_topk(v, m, shape)
            torch.cuda.synchronize()
            vr, mr = ref.encode_topk_ref(x, k, block)
            dr = ref.decode_topk_ref(vr, mr, shape)
            ok = bits_equal(v, vr) and bits_equal(m, mr) and bits_equal(d, dr)
            if not ok:
                raise AssertionError(
                    f"kernel != plain version: {dtype} {shape} k={k} "
                    f"block={block} {regime}")
            err["encode_topk"] = max(err["encode_topk"], float(
                (v.float() - vr.float()).abs().max()))
            err["decode_topk"] = max(err["decode_topk"], float(
                (d.float() - dr.float()).abs().max()))
            n_cases += 1
    print(f"kernel checks: {n_cases} cases x 2 kernels bit-exact against the "
          f"plain versions (fp32/bf16/fp16, ragged, zeros, ties, k=1, "
          f"k=4096, boundary shapes)")
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
        v, m = tk.encode_topk(x, k, block)
        item = x.element_size()
        enc_bytes = n * item + nb * k * item + nb * (block // 32) * 4
        dec_bytes = nb * k * item + nb * (block // 32) * 4 + n * item
        row = {
            "encode_ms": time_ms(lambda: tk.encode_topk(x, k, block)),
            "encode_plain_ms": time_ms(
                lambda: ref.encode_topk_ref(x, k, block), reps=10),
            "decode_ms": time_ms(lambda: tk.decode_topk(v, m, shape)),
            "decode_plain_ms": time_ms(
                lambda: ref.decode_topk_ref(v, m, shape), reps=10),
            "topk_selection_only_ms": time_ms(
                lambda: torch.topk(x.reshape(nb, block).abs(), k, dim=1)),
            # least time: bytes once each way over HBM, or one magnitude
            # compare per element at the fp32 rate — bytes win by far
            "encode_bound_ms": 1e3 * max(enc_bytes / HBM_BYTES_PER_S,
                                         n / FP32_OPS_PER_S),
            "decode_bound_ms": 1e3 * max(dec_bytes / HBM_BYTES_PER_S,
                                         n / FP32_OPS_PER_S),
            "shape": list(shape), "k_per_block": k, "blocks": nb}
        row.update(kernel_device_us(lambda: tk.decode_topk(
            *tk.encode_topk(x, k, block), shape)))
        out[tuple(shape)] = row
        print("timing " + json.dumps(row))
    return out


def kernel_device_us(fn, reps: int = 20) -> dict:
    """Device time per launch of each codec kernel, from the profiler's
    CUDA activity (``None`` where the profiler saw no device time).  The
    event times above also hold the gaps while the host prepares the next
    launch; these do not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = {"encode_device_us": None, "decode_device_us": None}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0)
        for kind in ("encode", "decode"):
            if f"{kind}_kernel" in ev.key and total and ev.count:
                found[f"{kind}_device_us"] = total / ev.count
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


def run_training_path(dev):
    import torch
    from repro_torch.configs import resolve
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.launch.train import train_fusion
    from repro_torch.obs import slog

    cfg = resolve("gpt2-xl").full
    log = slog.get_logger("chip_smoke")
    results = {}
    tk.reset_launch_counts()            # the main path's counts start here
    for compress in ("uniform", "adatopk"):
        before = {n: f.launches for n, f in tk.KERNELS.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = train_fusion(cfg, batch=BATCH, seq=SEQ, steps=STEPS, lr=3e-4,
                           compress=compress, ratio=100.0, testbed=1,
                           device=dev, use_kernel="auto", data_order=1,
                           log=log, log_every=1)
        wall = time.perf_counter() - t0
        msgs = compressed_messages(run.runtime.prog, run.plan)
        expect = msgs * 2 * 1 * STEPS   # both directions, 1 micro-batch
        got = {n: f.launches - before[n] for n, f in tk.KERNELS.items()}
        if not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"{compress}: non-finite loss {run.losses}")
        if any(v != expect for v in got.values()) or expect == 0:
            raise AssertionError(f"{compress}: launches {got}, expected "
                                 f"{expect} ({msgs} messages)")
        results[compress] = {
            "stages": len(run.schedule.stage_devices()),
            "compressed_edges": msgs,
            "ratios": sorted(set(run.plan.edge_ratio.values())),
            "losses": run.losses, "step_s": run.step_seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": got, "wall_s": wall,
            "sim_iteration_s": run.sim.iteration_time}
        print(f"training path {compress}: " + json.dumps(results[compress]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    totals = {n: f.launches for n, f in tk.KERNELS.items()}
    return results, totals


def check_against_reference(dev):
    """Small-size checks by the repository's own contracts, on the card:
    RAD without compression equals single-device autograd, and a few
    compressed AdamW steps through the CUDA kernels follow the CPU's plain
    codec on the same weights and data."""
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

    curves = {}
    for d in (dev, torch.device("cpu")):
        rt = DecentralizedRuntime(graph, sch,
                                  plan_uniform(graph, sch.placement, 10.0),
                                  use_kernel="auto", device=d)
        p = tree_map(lambda t: t.to(d), params_cpu)
        opt = adamw(1e-3, weight_decay=0.0)
        st = opt.init(p)
        curve = []
        for step in range(3):
            loss, g = rt.train_step(p, [ds.batch(b, step)])
            p, st = opt.update(g, st, p)
            curve.append(float(loss))
        curves[d.type] = curve
    gap = max(abs(x - y) / abs(y) for x, y in zip(curves["cuda"],
                                                  curves["cpu"]))
    if gap > 1e-3:
        raise AssertionError(f"card and CPU loss curves differ: {curves}")
    print(f"reference checks: RAD == single-device on the card (max rel "
          f"grad diff {worst:.3e}); compressed smoke curve cuda "
          f"{curves['cuda']} vs cpu {curves['cpu']} (max rel {gap:.3e})")


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
    results, launches = run_training_path(dev)
    check_against_reference(dev)

    main_shape = timing[(BATCH, SEQ, 1600)]
    kernels = []
    for name, short in (("encode_topk", "encode"), ("decode_topk", "decode")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": main_shape[f"{short}_ms"],
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
