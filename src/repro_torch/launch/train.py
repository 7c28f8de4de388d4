"""Training launcher.

Two modes, as in the JAX package:
* ``gspmd`` (the default) — the whole model (``causal_lm``) on one device:
  autograd, global-norm clip and AdamW each step;
* ``fusion`` — the paper's decentralized runtime: OP-Fence schedule over a
  simulated geo cluster, RAD executor with AdaTopK compression through the
  CUDA wire codec (``use_kernel="auto"``); reports the REAL loss curve and
  step time on the card plus the SIMULATED per-iteration wall time on the
  chosen testbed.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --size smoke --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-xl \
        --size smoke --mode fusion --steps 50 --compress adatopk --ratio 100

Runs on ``--device cuda`` (the default; a missing card is an error) or
``--device cpu``.  Reporting goes through :mod:`repro_torch.obs.slog` —
``event k=v`` lines on stderr.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import slog


@dataclasses.dataclass
class FusionRun:
    """What one fusion training run produced."""

    losses: List[float]
    step_seconds: List[float]     # host wall clock per step, device synced
    runtime: Any                  # the DecentralizedRuntime that ran it
    plan: Any                     # its CompressionPlan
    schedule: Any
    sim: Any                      # simulate_iteration's SimResult


def train_fusion(cfg, *, batch: int = 8, seq: int = 128, steps: int = 50,
                 lr: float = 3e-3, compress: str = "none",
                 ratio: float = 100.0, testbed: int = 1,
                 device: DeviceLike = "cuda", use_kernel: Any = "auto",
                 data_order: int = 2, seed: int = 0,
                 error_feedback: bool = False,
                 log: Optional[slog.StructuredLogger] = None,
                 log_every: int = 10) -> FusionRun:
    """Schedule ``cfg``'s OP-DAG on paper testbed ``testbed``, plan the
    compression (``none``/``uniform``/``adatopk`` at ``ratio``), and train
    ``steps`` AdamW steps through :class:`DecentralizedRuntime` on
    ``device``.  Weights are random, from ``seed``; data is
    :class:`SyntheticLM` of Markov order ``data_order``.
    ``error_feedback`` sets the compressing plans' own field: the runtime
    then sends each boundary gradient through EF-SGD residual memory."""
    from repro_torch.core import (DecentralizedRuntime, network, plan_adatopk,
                                  plan_none, plan_uniform, schedule_opfence,
                                  simulate_iteration)
    from repro_torch.data import SyntheticLM
    from repro_torch.models.opgraph_models import gpt_opgraph
    from repro_torch.optim import (adamw, distinct_storage,
                                   linear_warmup_cosine)

    dev = resolve_device(device)
    log = log or slog.get_logger("train")
    cfg = cfg.replace(max_seq=max(cfg.max_seq, seq))
    graph = gpt_opgraph(cfg, batch, seq)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    prof = graph.annotate(shapes)
    cluster = network.paper_testbed(testbed, seed=0)
    sch = schedule_opfence(graph, prof, cluster)
    plan = {"none": lambda: plan_none(graph, sch.placement),
            "uniform": lambda: plan_uniform(graph, sch.placement, ratio,
                                            error_feedback=error_feedback),
            "adatopk": lambda: plan_adatopk(graph, prof, cluster,
                                            sch.placement, ratio,
                                            error_feedback=error_feedback)
            }[compress]()
    sim = simulate_iteration(graph, prof, sch, cluster, plan, n_micro=2)
    log.event("fusion_plan", testbed=testbed,
              stages=len(sch.stage_devices()),
              sim_iteration_s=sim.iteration_time,
              comm_mb=sim.comm_bytes / 1e6)
    runtime = DecentralizedRuntime(graph, sch, plan, use_kernel=use_kernel,
                                   device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = graph.init(gen, shapes)
    opt = adamw(linear_warmup_cosine(lr, 10, steps), weight_decay=0.0)
    state = opt.init(params)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0, order=data_order)

    losses: List[float] = []
    step_seconds: List[float] = []
    for i in range(steps):
        b = ds.batch(batch, i)
        t0 = time.perf_counter()
        loss, grads = runtime.train_step(params, [b])
        # the step owns its gradients and state: the update computes in
        # their memory
        params, state = opt.update(distinct_storage(grads), state, params,
                                   consume_grads=True)
        del grads
        losses.append(float(loss))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_seconds.append(time.perf_counter() - t0)
        if i % log_every == 0:
            log.event("train_step", step=i, loss=losses[-1],
                      step_s=step_seconds[-1],
                      sim_wall_s=sim.iteration_time * (i + 1))
    return FusionRun(losses=losses, step_seconds=step_seconds,
                     runtime=runtime, plan=plan, schedule=sch, sim=sim)


@dataclasses.dataclass
class GspmdRun:
    """What one gspmd training run produced."""

    losses: List[float]
    step_seconds: List[float]     # host wall clock per step, device synced
    metrics: List[dict]           # per step: loss, grad_norm, ce, aux
    params: Any                   # the trained parameters
    opt_state: Any


def train_gspmd(cfg, *, batch: int = 8, seq: int = 128, steps: int = 50,
                lr: float = 3e-3, device: DeviceLike = "cuda",
                optimizer: Any = None, params: Any = None,
                data_order: int = 2, ckpt_dir: Optional[str] = None,
                ckpt_every: int = 0,
                log: Optional[slog.StructuredLogger] = None,
                log_every: int = 10) -> GspmdRun:
    """Train ``cfg``'s whole model for ``steps`` steps on ``device``
    through ``make_train_step``.  ``optimizer`` defaults to the JAX
    launcher's AdamW (warm-up 10 steps, cosine to ``steps``, no weight
    decay).  Weights are ``params`` (moved to ``device``) or random from
    seed 0; data is :class:`SyntheticLM` of Markov order ``data_order``.
    Every ``ckpt_every`` steps the parameters go to ``ckpt_dir`` in the JAX
    package's ``.npz`` layout."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core.rad import tree_map
    from repro_torch.data import ShardedLoader, SyntheticLM
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import causal_lm
    from repro_torch.optim import adamw, linear_warmup_cosine

    dev = resolve_device(device)
    log = log or slog.get_logger("train")
    cfg = cfg.replace(max_seq=max(cfg.max_seq, seq))
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = causal_lm.init(cfg, gen)
    else:
        params = tree_map(lambda t: t.to(dev), params)
    opt = optimizer or adamw(linear_warmup_cosine(lr, 10, steps),
                             weight_decay=0.0)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0, order=data_order)
    loader = ShardedLoader((ds.batch(batch, i) for i in range(steps)), dev)

    losses: List[float] = []
    step_seconds: List[float] = []
    metrics: List[dict] = []
    for i in range(steps):
        t0 = time.perf_counter()
        b = next(loader)
        params, state, m = step_fn(params, state, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        losses.append(metrics[-1]["loss"])
        if i % log_every == 0:
            log.event("train_step", step=i, loss=losses[-1],
                      grad_norm=metrics[-1]["grad_norm"],
                      step_s=step_seconds[-1])
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, params,
                            metadata={"arch": cfg.name, "mode": "gspmd"})
    return GspmdRun(losses=losses, step_seconds=step_seconds,
                    metrics=metrics, params=params, opt_state=state)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-xl")
    ap.add_argument("--size", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--mode", choices=["gspmd", "fusion"], default="gspmd")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress", choices=["none", "uniform", "adatopk"],
                    default="none")
    ap.add_argument("--ratio", type=float, default=100.0)
    ap.add_argument("--testbed", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    slog.add_logging_args(ap)
    args = ap.parse_args(argv)
    metrics = MetricsRegistry()
    log = slog.get_logger("train", metrics=metrics,
                          level=slog.level_from_args(args))

    from repro_torch.configs import resolve

    entry = resolve(args.arch)
    cfg = entry.smoke if args.size == "smoke" else entry.full
    if args.mode == "gspmd":
        run = train_gspmd(cfg, batch=args.batch, seq=args.seq,
                          steps=args.steps, lr=args.lr, device=args.device,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          log=log, log_every=args.log_every)
    else:
        run = train_fusion(cfg, batch=args.batch, seq=args.seq,
                           steps=args.steps, lr=args.lr,
                           compress=args.compress, ratio=args.ratio,
                           testbed=args.testbed, device=args.device, log=log,
                           log_every=args.log_every)
    log.event("train_done", mode=args.mode, steps=args.steps,
              final_loss=run.losses[-1], start_loss=run.losses[0])
    return run.losses


if __name__ == "__main__":
    main()
