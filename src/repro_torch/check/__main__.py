"""``python -m repro_torch.check`` — static plan-verification CLI.

Modes (composable; no flags runs ``--all-configs --lint``):

* ``--all-configs`` / ``--config ARCH`` — build each committed
  architecture's smoke OP-DAG, profile it, co-plan a joint
  schedule + AdaTopK plan on the paper testbed, and run every checker
  (graph, profiles, schedule, compression plan, cost model) over the
  artifacts.  A config that cannot even plan is itself a finding.
* ``--lint`` — the repo-custom AST lint over ``src/repro_torch/``
  (``--lint-json PATH`` additionally writes the findings as JSON for
  the CI artifact).
* ``--docs`` — relative-link check over README/ROADMAP/docs/ markdown
  (jax-free; see :mod:`repro_torch.check.docs`).
* ``--trace PATH`` — happens-before check on a recorded span log
  (``.jsonl`` or Chrome-trace ``.json``), repeatable.
* ``--bench PATH`` — schema-validate a BENCH result/baseline JSON
  (repeatable); ``--bench-tracked METRIC`` overrides the tracked-metric
  set the gate keys on (repeatable, default ``pace``/``phi``).

Exit status 1 when any error-severity finding survives; warnings print
but do not fail (``--strict`` promotes them).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from .errors import Finding, SEV_ERROR


def check_config(arch: str, batch: int = 2, seq: int = 128,
                 seed: int = 0, ratio: float = 100.0) -> List[Finding]:
    """Full checker sweep over one committed architecture: smoke config
    -> metadata OP-DAG -> profiles -> joint (OP-Fence x AdaTopK) plan on
    paper testbed 1 -> every invariant."""
    from repro_torch.configs import resolve
    from repro_torch.core.network import paper_testbed
    from repro_torch.core.scheduler import schedule_joint
    from repro_torch.models.opgraph_models import profile_opgraph

    from .costs import check_compression_plan, check_cost_model
    from .graph import check_graph, check_profiles
    from .schedule import check_schedule

    cfg = resolve(arch).smoke
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}
    try:
        graph = profile_opgraph(cfg, batch, seq)
    except Exception as e:   # a config that cannot build is a finding
        return [Finding("config-build", arch,
                        f"profile_opgraph failed: {e}")]
    findings = check_graph(graph, shapes)
    profiles = graph.annotate(shapes)
    findings += check_profiles(graph, profiles, shapes)
    if any(f.severity == SEV_ERROR for f in findings):
        return findings      # planning over a broken graph is noise
    cluster = paper_testbed(1, seed=seed)
    try:
        jp = schedule_joint(graph, profiles, cluster, ratio=ratio,
                            seed=seed, verify=False)
    except Exception as e:
        return findings + [Finding("config-plan", arch,
                                   f"schedule_joint failed: {e}")]
    findings += check_schedule(graph, jp.schedule, profiles=profiles,
                               cluster=cluster)
    findings += check_compression_plan(graph, profiles, jp.plan,
                                       jp.schedule.placement)
    findings += check_cost_model(jp.cost_model, jp.schedule.placement)
    return findings


def _report(label: str, findings: Sequence[Finding]) -> int:
    errs = [f for f in findings if f.severity == SEV_ERROR]
    warns = [f for f in findings if f.severity != SEV_ERROR]
    if errs:
        print(f"{label}: FAIL ({len(errs)} errors"
              + (f", {len(warns)} warnings" if warns else "") + ")")
    else:
        print(f"{label}: OK"
              + (f" ({len(warns)} warnings)" if warns else ""))
    for f in list(errs) + list(warns):
        print(f"  - {f}")
    return len(errs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description=__doc__.splitlines()[0])
    ap.add_argument("--all-configs", action="store_true",
                    help="verify every committed architecture config")
    ap.add_argument("--config", action="append", default=[],
                    metavar="ARCH", help="verify one arch (repeatable)")
    ap.add_argument("--lint", action="store_true",
                    help="run the repo-custom AST lint over src/repro_torch/")
    ap.add_argument("--lint-json", metavar="PATH",
                    help="also write lint findings as JSON (CI artifact)")
    ap.add_argument("--docs", action="store_true",
                    help="link-check README/ROADMAP/docs/ markdown")
    ap.add_argument("--trace", action="append", default=[], metavar="PATH",
                    help="happens-before check a span log (repeatable)")
    ap.add_argument("--bench", action="append", default=[], metavar="PATH",
                    help="schema-validate a BENCH result JSON (repeatable)")
    ap.add_argument("--bench-tracked", action="append", default=[],
                    metavar="METRIC",
                    help="tracked metric the bench gate keys on "
                         "(repeatable; default: pace, phi)")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as errors")
    args = ap.parse_args(argv)

    if not (args.all_configs or args.config or args.lint
            or args.lint_json or args.docs or args.trace or args.bench):
        args.all_configs = args.lint = True

    n_errors = 0
    if args.all_configs or args.config:
        from repro_torch.configs import ARCH_IDS
        archs = list(ARCH_IDS) if args.all_configs else []
        archs += [a for a in args.config if a not in archs]
        for arch in archs:
            findings = check_config(arch)
            if args.strict:
                findings = [Finding(f.code, f.where, f.message)
                            for f in findings]
            n_errors += _report(f"config {arch}", findings)

    if args.lint or args.lint_json:
        from .lint import lint_tree
        findings = lint_tree()
        if args.strict:
            findings = [Finding(f.code, f.where, f.message)
                        for f in findings]
        n_errors += _report("lint src/repro_torch", findings)
        if args.lint_json:
            with open(args.lint_json, "w") as f:
                json.dump([{"code": x.code, "where": x.where,
                            "message": x.message, "severity": x.severity}
                           for x in findings], f, indent=2)
            print(f"lint findings written to {args.lint_json}")

    if args.docs:
        from .docs import check_docs
        findings = check_docs()
        if args.strict:
            findings = [Finding(f.code, f.where, f.message)
                        for f in findings]
        n_errors += _report("docs markdown links", findings)

    for path in args.bench:
        from .bench import TRACKED_DEFAULT, check_bench_result
        tracked = tuple(args.bench_tracked) or TRACKED_DEFAULT
        try:
            with open(path) as f:
                payload = json.load(f)
        except Exception as e:
            n_errors += _report(f"bench {path}",
                                [Finding("bench-load", path,
                                         f"cannot load: {e}")])
            continue
        findings = check_bench_result(payload, tracked=tracked, source=path)
        if args.strict:
            findings = [Finding(f.code, f.where, f.message)
                        for f in findings]
        n_errors += _report(f"bench {path}", findings)

    for path in args.trace:
        from .traceorder import check_trace_order, load_trace_events
        try:
            events = load_trace_events(path)
        except Exception as e:
            n_errors += _report(f"trace {path}",
                                [Finding("trace-load", path,
                                         f"cannot load: {e}")])
            continue
        findings = check_trace_order(events)
        if args.strict:
            findings = [Finding(f.code, f.where, f.message)
                        for f in findings]
        n_errors += _report(f"trace {path} ({len(events)} events)",
                            findings)

    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
