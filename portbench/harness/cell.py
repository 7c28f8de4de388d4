"""One run of one cell: set-up, the measured window, the check.

Set-up makes the weights from the seed on the device, a pool of batches
from the seed, and the program's training step; it drives that step
through its first ``check_steps`` steps on the pool's first rows (which
warm up every shape the window uses) and reads the program's state as the
check needs it.  The window then trains on the pool's next batches, one
step a call, each ending when the device has finished, for ``seconds``.
After it, the program's state is freed and the plain reference trains the
same weights on the same rows; ``correct`` is the comparison's verdict.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from portbench.harness import data, manifest, program, weights, yardstick
from portbench.reference import compare, model, planner

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _edge_k(cfg: dict, traffic: dict) -> tuple:
    """The reference's own plan and each compressed edge's k a block."""
    B, S = traffic["batch"], traffic["seq"]
    if traffic["mode"] != "fusion":
        return None, {}
    ref_plan = planner.plan(cfg, B, S, traffic["compress"], traffic["ratio"],
                            traffic["testbed"])
    numel = {o[0]: o[3] for o in planner.op_chain(cfg, B, S)}
    return ref_plan, {e: planner.block_k(numel[e[0]], r)
                      for e, r in ref_plan["edges"].items()}


def reference_readings(cfg: dict, traffic: dict, seed: int, batches,
                       device: torch.device, dtype=torch.float32,
                       split: bool = False) -> dict:
    """The plain reference's readings for ``seed`` on ``batches``."""
    layout, S = traffic["mode"], traffic["seq"]
    _, edge_k = _edge_k(cfg, traffic)
    params = weights.make(cfg, layout, S, seed, device)
    got = model.train_readings(cfg, layout, traffic, params, batches, edge_k,
                               dtype, split)
    before = weights.make(cfg, layout, S, seed, device)
    got["change"] = model.change_norms(params, before)
    del params, before
    return got


def pool(cell: dict, seed: int, device: torch.device, n: int = 64):
    """(tokens, labels) of the run's batches: (n, batch, seq) on
    ``device``; the first ``check_steps`` are the checked steps'."""
    cfg, tr = cell["config"], cell["traffic"]
    toks, labs = data.markov_batches(cfg["vocab"], tr["batch"], tr["seq"],
                                     max(n, tr["check_steps"] + 1), seed,
                                     tr["data_order"], tr["noise"])
    return (torch.as_tensor(toks).to(device),
            torch.as_tensor(labs).to(device))


def check_batches(cell: dict, seed: int, device: torch.device):
    tokens, labels = pool(cell, seed, device)
    return [(tokens[i], labels[i])
            for i in range(cell["traffic"]["check_steps"])]


class Run:
    """A cell's program, set up from ``seed`` and driven through its first
    steps; ``readings`` holds what the check compares."""

    def __init__(self, cell: dict, seed: int, device: torch.device,
                 fault: Optional[str] = None):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        tr = self.traffic
        S, n_check = tr["seq"], tr["check_steps"]
        if tr["micro_batches"] != 1:
            raise ValueError("the harness drives one micro-batch a step")
        self.parts: Dict[str, float] = {}
        t = time.perf_counter()
        if tr["mode"] == "fusion" and device.type == "cuda":
            from repro_torch.kernels import topk_compress
            topk_compress.load_library()
        self.parts["codec_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        params = weights.make(self.cfg, tr["mode"], S, seed, device)
        _sync(device)
        self.parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.tokens, self.labels = pool(cell, seed, device)
        self.parts["data_s"] = time.perf_counter() - t
        self.prog = program.build(self.cfg, tr, params, device, fault)
        del params
        self.parts["plan_s"] = self.prog.plan_s or 0.0
        losses, self.parts["warmup_steps_s"] = [], []
        for i in range(n_check):
            t = time.perf_counter()
            loss = self.prog.step(self.tokens[i], self.labels[i])
            losses.append(float(loss))
            self.parts["warmup_steps_s"].append(time.perf_counter() - t)
            if i == 0:
                g1 = {n: float(m.norm()) / (1 - tr["b1"])
                      for n, m in model.leaves(self.prog.first_moment())}
        t = time.perf_counter()
        before = weights.make(self.cfg, tr["mode"], S, seed, device)
        change = model.change_norms(self.prog.params, before)
        del before
        self.parts["readings_s"] = time.perf_counter() - t
        self.readings = {"losses": losses, "g1": g1, "change": change}
        self.next = n_check

    def batch(self):
        i = self.next % self.tokens.shape[0]
        if i < self.traffic["check_steps"]:
            i = self.traffic["check_steps"]
        self.next = i + 1
        return self.tokens[i], self.labels[i]

    def window(self, seconds: float, traced: bool = False):
        """Steps until ``seconds`` have passed: (steps, failed, window
        seconds)."""
        steps = failed = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            tokens, labels = self.batch()
            try:
                loss = self.prog.step(tokens, labels, traced)
                if traced:
                    with torch.profiler.record_function("step_end"):
                        _sync(self.device)
                        value = float(loss)
                else:
                    _sync(self.device)
                    value = float(loss)
                if not math.isfinite(value):
                    failed += 1
            except RuntimeError as exc:
                print(f"step {steps} failed: {exc}", file=sys.stderr)
                failed += 1
            steps += 1
            now = time.perf_counter()
            if now >= end:
                return steps, failed, now - t0

    def plan_diff(self) -> Optional[int]:
        ref_plan, _ = _edge_k(self.cfg, self.traffic)
        if ref_plan is None:
            return None
        return compare.plan_diff(self.prog.stages(), ref_plan)

    def codec_edges(self):
        if self.traffic["mode"] != "fusion":
            return []
        tr = self.traffic
        return planner.codec_shapes(self.cfg, tr["batch"], tr["seq"],
                                    dict(self.prog.stages()[1]))

    def free(self) -> None:
        del self.prog
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check_batches(self):
        n = self.traffic["check_steps"]
        return [(self.tokens[i], self.labels[i]) for i in range(n)]


def run(name: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, fault: Optional[str] = None,
        cell: Optional[dict] = None) -> dict:
    """One run of cell ``name``; the result line's object."""
    cell = cell or manifest.cell(name)
    tr = cell["traffic"]
    tokens_a_step = tr["batch"] * tr["seq"]
    r = Run(cell, seed, device, fault)
    cuda = device.type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        from repro_torch.kernels import topk_compress
        topk_compress.reset_launch_counts()
    else:
        setup_peak = 0
    setup_s = time.time() - t_start
    trace = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                steps, failed, window_s = r.window(seconds, True)
        if cuda:
            from portbench.harness import trace as trace_mod
            trace = trace_mod.read(prof, manifest.ROOT / "build" / "portbench")
        del prof
    else:
        steps, failed, window_s = r.window(seconds)
    launches = 0
    window_peak = 0
    if cuda:
        window_peak = torch.cuda.max_memory_allocated(device)
        from repro_torch.kernels import topk_compress
        launches = sum(fn.launches for fn in topk_compress.KERNELS.values())
    ctx = SimpleNamespace(
        trace=trace, spans=r.prog.spans, steps=steps, plan_s=r.prog.plan_s,
        codec_edges=r.codec_edges(), codec_launches=launches,
        flops_per_step=yardstick.step_flops(cell["config"], tr["batch"],
                                            tr["seq"]))
    plan = r.plan_diff()
    prog_readings = r.readings
    batches = r.check_batches()
    parts = dict(r.parts)
    r.free()
    t = time.perf_counter()
    ref = reference_readings(cell["config"], tr, seed, batches, device)
    parts["reference_s"] = time.perf_counter() - t
    nums = compare.numbers(prog_readings, ref, plan)
    limits = cell["limits"]
    correct = compare.verdict(nums, limits) and failed == 0

    if traced:
        metrics = {}
        for entry in cell["per_layer"]:
            mod = manifest.metric_module(entry["name"])
            value = mod.read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        values = {"tokens_per_s": steps * tokens_a_step / window_s,
                  "peak_mem_gb": window_peak / 1e9, "setup_s": setup_s}
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e in cell["end_to_end"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": correct, "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.device_ops(),
                            "idle_gaps": trace.idle_gaps()}
    out["setup_parts"] = parts
    out["numbers"] = nums
    out["checks"] = {k: {"value": nums.get(k), "limit": v}
                     for k, v in limits.items()}
    return out
