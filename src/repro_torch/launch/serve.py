"""Swarm serving launcher: stage-sharded decode over a simulated cluster.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --rate 200 --n-stages 2 --churn [--device cpu]

Thin CLI over :class:`repro_torch.serving.ServingRuntime`: builds the model
from a committed architecture config (random weights from ``--seed``),
stage-shards it across a simulated cluster, replays a Poisson request trace
through the continuous-batching loop, and reports tokens/s + per-token
latency percentiles.  ``--churn`` scripts a mid-session stage-replica
failure (derived from a dry run so it is guaranteed to interrupt a live
session) and re-runs the same offered load through the re-route + KV-replay
path.  The model computes on ``--device`` (the card by default; without
one it raises).

Artifacts: ``--trace``/``--flight`` write the span log and the routing
decision log.  Timing events go through :mod:`repro_torch.obs.slog`.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.obs import (FlightRecorder, MetricsRegistry, TraceRecorder,
                             slog, write_jsonl)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--size", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--devices", type=int, default=6,
                    help="simulated cluster size")
    ap.add_argument("--cluster", choices=["lan", "geo"], default="geo",
                    help="homogeneous LAN or geo-distributed sites")
    ap.add_argument("--n-stages", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (req/s, simulated)")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 12),
                    metavar=("LO", "HI"))
    ap.add_argument("--gen", type=int, nargs=2, default=(16, 32),
                    metavar=("LO", "HI"), help="per-request new tokens")
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="KV slots per stage replica")
    ap.add_argument("--churn", action="store_true",
                    help="also run a scripted mid-session failure leg")
    ap.add_argument("--lease", type=float, default=1e-5,
                    help="failure-detection lease (simulated s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model computes: cuda (default) or cpu")
    ap.add_argument("--trace", metavar="PATH",
                    help="write span log JSONL (churn leg when --churn)")
    ap.add_argument("--flight", metavar="PATH",
                    help="write routing decision log JSONL")
    slog.add_logging_args(ap)
    return ap


def run_leg(cfg, params, plan, requests, n_devices: int, churn,
            lease_s: float, device, on_token=None):
    """One leg of the launcher: ``requests`` through a fresh
    :class:`ServingRuntime` over ``plan`` against the ``churn`` trace, with
    a span log and a flight recorder.  Returns ``(report, trace,
    flight)``."""
    from repro_torch.elastic.membership import MembershipView
    from repro_torch.serving import ServingRuntime

    view = MembershipView(n_devices, churn, lease_s=lease_s)
    tr = TraceRecorder()
    fl = FlightRecorder()
    runtime = ServingRuntime(cfg, params, plan, view, trace=tr, flight=fl,
                             on_token=on_token, device=device)
    return runtime.run(list(requests)), tr, fl


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    log = slog.get_logger("serve", metrics=MetricsRegistry(),
                          level=slog.level_from_args(args))

    from repro_torch.configs import resolve
    from repro_torch.core.network import geo_random, homogeneous_lan
    from repro_torch.device import resolve_device
    from repro_torch.elastic.membership import ChurnTrace
    from repro_torch.models import causal_lm
    from repro_torch.serving import (ServingCostModel, churn_trace_for,
                                     derive_midsession_failure,
                                     plan_serving, poisson_trace)

    dev = resolve_device(args.device)
    cfg = resolve(args.arch).smoke if args.size == "smoke" \
        else resolve(args.arch).full
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = causal_lm.init(cfg, gen)
    cluster = homogeneous_lan(args.devices) if args.cluster == "lan" \
        else geo_random(args.devices, seed=args.seed)
    costs = ServingCostModel(cfg, cluster)
    plan = plan_serving(cfg, costs, list(range(args.devices)),
                        n_stages=args.n_stages, cache_len=args.cache_len,
                        max_batch=args.max_batch)
    for line in plan.describe().splitlines():
        log.debug("plan", line=line)
    requests = poisson_trace(args.requests, rate=args.rate, vocab=cfg.vocab,
                             prompt_len=tuple(args.prompt_len),
                             gen_len=tuple(args.gen), seed=args.seed)

    def leg(name: str, churn):
        report, tr, fl = run_leg(cfg, params, plan, requests, args.devices,
                                 churn, args.lease, dev)
        log.event(name, **report.to_dict())
        return report, tr, fl

    report, tr, fl = leg("no_churn", ChurnTrace(()))
    if args.churn:
        victim, at, _, _ = derive_midsession_failure(
            cfg, params, plan, requests, args.devices, lease_s=args.lease,
            device=dev)
        log.event("scripted_failure", victim=victim, at=at)
        report, tr, fl = leg("churn", churn_trace_for(victim, at))
        if not report.all_completed:
            raise SystemExit("churn leg dropped sessions — "
                             "re-route failed to recover")
    if args.trace:
        write_jsonl(tr.events(), args.trace)
        log.event("artifact", kind="trace", path=args.trace)
    if args.flight:
        fl.to_jsonl(args.flight)
        log.event("artifact", kind="flight", path=args.flight)


if __name__ == "__main__":
    main()
