"""Cost-model and compression-plan checks (repro_torch.check, component 3).

The whole planning stack promises that **every transported byte is
derivable from the** :class:`repro_torch.core.costmodel.EdgeCostModel` — the
estimator and the discrete-event simulator read the same
``edge_wire_bytes``/``link_seconds``, so their parity is structural, not
a numerical coincidence.  :func:`check_cost_model` re-derives each cross
edge from first principles (profile numel x dtype itemsize x wire
encoding x alpha-beta link x correction) and flags any edge whose model
answer cannot be reproduced, any edge whose wire bytes exceed the dense
payload (AdaTopK's break-even guarantee), and any calibrated link
correction outside :func:`fit_link_corrections`' clamp.

:func:`check_compression_plan` validates an AdaTopK
:class:`CompressionPlan` on its own: known encoding, finite ratios, every
ratio above its edge's dtype-exact break-even, no integer-rounding wire
inflation, and (when a placement is given) every planned edge actually
crossing CompNodes.

With the codec kernels on the path, compression also costs *compute*:
when a ``cost_model`` carrying calibrated per-device
:class:`repro_torch.core.costmodel.KernelCostModel` entries is supplied, both
checkers enforce the FusionLLM §6 premise that compression must outrun the
bandwidth it buys back — any planned edge whose encode seconds meet or
exceed the wire seconds saved is a ``compression-unprofitable`` finding
(the planner's profitability guard should have dropped it).
"""
from __future__ import annotations

import math
from typing import List, Mapping, Optional

from repro_torch.core.compression import (CompressionPlan, encoding_break_even,
                                    wire_bytes)
from repro_torch.core.costmodel import EdgeCostModel
from repro_torch.core.opgraph import OpGraph, OpProfile

from .errors import (CompressionCheckError, CostCheckError, Finding,
                     SEV_WARN, raise_findings)

_ENCODINGS = ("paper", "mask", "none")
_CORRECTION_CLAMP = (0.25, 4.0)
_REL_TOL = 1e-9


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL_TOL, abs_tol=1e-12)


def check_cost_model(model: EdgeCostModel,
                     placement: Mapping[str, int]) -> List[Finding]:
    """Structural estimator/simulator parity for every cross edge under
    ``placement``, plus correction-clamp sanity."""
    out: List[Finding] = []
    for dev, kc in sorted(model.kernel_costs.items()):
        if not (math.isfinite(kc.alpha) and kc.alpha >= 0.0) \
                or not kc.bytes_per_second > 0.0:
            out.append(Finding(
                "bad-kernel-cost", f"dev{dev}",
                f"device {dev}: kernel cost alpha={kc.alpha!r} "
                f"bytes_per_second={kc.bytes_per_second!r} — alpha must be "
                "finite and >= 0, throughput positive (inf = free)"))
    for (i, j), c in sorted(model.link_corrections.items()):
        if not math.isfinite(c) or not \
                _CORRECTION_CLAMP[0] <= c <= _CORRECTION_CLAMP[1]:
            out.append(Finding(
                "correction-out-of-clamp", f"dev{i}->dev{j}",
                f"link correction {c!r} outside the fit clamp "
                f"{_CORRECTION_CLAMP} — not a fit_link_corrections product"))
    for (a, n) in model.cross_edges(placement):
        edge = f"{a}->{n}"
        src, dst = placement[a], placement[n]
        dense = model.dense_bytes(a)
        wire = model.edge_wire_bytes(a, n)
        if not (math.isfinite(wire) and wire >= 0.0
                and math.isfinite(dense) and dense >= 0.0):
            out.append(Finding("bad-edge-bytes", edge,
                               f"edge {edge}: dense={dense!r} "
                               f"wire={wire!r} must be finite and >= 0"))
            continue
        # re-derive the wire bytes from the plan's ratio + the producer's
        # profile dtype — the only sanctioned arithmetic
        r = model.ratio(a, n)
        if r <= 1.0 or model.encoding == "none":
            expect = dense
        else:
            expect = wire_bytes(model.numel(a), r, model.encoding,
                                itemsize=model.itemsize(a))
        if not _close(wire, expect):
            out.append(Finding(
                "wire-bytes-underivable", edge,
                f"edge {edge}: model says {wire} wire bytes but the "
                f"encoding arithmetic gives {expect} (ratio {r:g}, "
                f"encoding {model.encoding!r})"))
        if wire > dense and not _close(wire, dense):
            out.append(Finding(
                "wire-inflation", edge,
                f"edge {edge}: {wire:.0f} wire bytes exceed the dense "
                f"{dense:.0f} — the break-even clamp is broken"))
        try:
            base = model.cluster.comm_time(src, dst, wire)
        except KeyError:
            out.append(Finding(
                "missing-link", f"dev{src}->dev{dst}",
                f"edge {edge} crosses CompNodes {src}->{dst} with no link "
                "in the cluster spec"))
            continue
        expect_s = base * model.link_corrections.get((src, dst), 1.0)
        got_s = model.edge_seconds(a, n, src, dst)
        if not _close(got_s, expect_s):
            out.append(Finding(
                "seconds-underivable", edge,
                f"edge {edge}: model prices {got_s!r}s but "
                f"alpha-beta x correction gives {expect_s!r}s"))
        enc_s = model.compress_seconds(a, n, src)
        if enc_s > 0.0:
            saved = model.link_seconds(src, dst, dense) - got_s
            if enc_s >= saved and not _close(enc_s, saved):
                out.append(Finding(
                    "compression-unprofitable", edge,
                    f"edge {edge}: encode costs {enc_s:.3g}s on dev{src}'s "
                    f"codec but saves only {saved:.3g}s of wire time — "
                    "compressing this edge slows the step down"))
    return out


def check_compression_plan(graph: OpGraph,
                           profiles: Mapping[str, OpProfile],
                           plan: Optional[CompressionPlan],
                           placement: Optional[Mapping[str, int]] = None,
                           cost_model: Optional[EdgeCostModel] = None
                           ) -> List[Finding]:
    """AdaTopK plan invariants; ``plan=None`` (dense transport) passes.

    ``cost_model`` (needs ``placement`` too) additionally enforces encode
    profitability per planned cross edge: with calibrated kernel costs, an
    edge whose codec seconds meet or exceed the wire seconds its ratio saves
    is a ``compression-unprofitable`` finding.  A model without kernel
    costs prices encode as free, so the check passes vacuously (legacy)."""
    if plan is None:
        return []
    out: List[Finding] = []
    if plan.encoding not in _ENCODINGS:
        out.append(Finding("unknown-encoding", plan.encoding,
                           f"encoding {plan.encoding!r} not in "
                           f"{_ENCODINGS}"))
        return out
    if not math.isfinite(plan.base_ratio) or plan.base_ratio < 1.0:
        out.append(Finding("bad-base-ratio", f"{plan.base_ratio!r}",
                           f"base_ratio {plan.base_ratio!r} must be finite "
                           "and >= 1"))
    for (a, n), r in sorted(plan.edge_ratio.items()):
        edge = f"{a}->{n}"
        if a not in graph.nodes or n not in graph.nodes:
            out.append(Finding("unknown-op", edge,
                               f"planned edge {edge} references an op "
                               "absent from the graph"))
            continue
        if not math.isfinite(r) or r < 1.0:
            out.append(Finding("ratio-invalid", edge,
                               f"edge {edge}: ratio {r!r} must be finite "
                               "and >= 1"))
            continue
        prof = profiles.get(a)
        if prof is None:
            out.append(Finding("missing-profile", edge,
                               f"planned edge {edge}: producer {a!r} has "
                               "no OpProfile to derive bytes from"))
            continue
        numel = 1
        for d in prof.out_shape:
            numel *= int(d)
        itemsize = max(1, int(round(prof.out_bytes / numel))) \
            if numel > 0 and prof.out_bytes else 4
        if r > 1.0 and plan.encoding != "none":
            be = encoding_break_even(plan.encoding, itemsize)
            if r <= be:
                out.append(Finding(
                    "ratio-below-break-even", edge,
                    f"edge {edge}: ratio {r:g} <= break-even {be:g} for "
                    f"{plan.encoding!r}@itemsize {itemsize} — this edge "
                    "INFLATES wire traffic"))
                continue
            wire = wire_bytes(numel, r, plan.encoding, itemsize=itemsize)
            dense = float(prof.out_bytes)
            if wire >= dense and dense > 0:
                out.append(Finding(
                    "wire-inflation", edge,
                    f"edge {edge}: ratio {r:g} encodes to {wire:.0f} wire "
                    f"bytes >= dense {dense:.0f} (ceil rounding "
                    "re-inflated it)"))
        if placement is not None:
            pa, pn = placement.get(a), placement.get(n)
            if pa is None or pn is None:
                out.append(Finding("unknown-op", edge,
                                   f"planned edge {edge} references an op "
                                   "absent from the placement"))
            elif pa == pn:
                out.append(Finding(
                    "plan-edge-not-cross", edge,
                    f"planned edge {edge} does not cross CompNodes under "
                    "this placement (stale plan?)", severity=SEV_WARN))
    if cost_model is not None and placement is not None:
        m = cost_model.with_plan(plan)
        for (a, n) in m.cross_edges(placement):
            if (a, n) not in plan.edge_ratio:
                continue
            src, dst = placement[a], placement[n]
            enc_s = m.compress_seconds(a, n, src)
            if enc_s <= 0.0:
                continue
            try:
                wire_s = m.edge_seconds(a, n, src, dst)
                dense_s = m.link_seconds(src, dst, m.dense_bytes(a))
            except KeyError:
                continue   # missing-link is check_cost_model's finding
            saved = dense_s - wire_s
            if enc_s >= saved and not _close(enc_s, saved):
                out.append(Finding(
                    "compression-unprofitable", f"{a}->{n}",
                    f"planned edge {a}->{n}: encode costs {enc_s:.3g}s on "
                    f"dev{src}'s codec but saves only {saved:.3g}s of wire "
                    "time — the plan slows the step down"))
    return out


def verify_plan(graph: OpGraph, profiles: Mapping[str, OpProfile],
                plan: Optional[CompressionPlan],
                placement: Optional[Mapping[str, int]] = None,
                cost_model: Optional[EdgeCostModel] = None,
                strict: bool = False) -> List[Finding]:
    findings = check_compression_plan(graph, profiles, plan, placement,
                                      cost_model)
    return raise_findings(findings, CompressionCheckError,
                          "compression plan failed verification",
                          strict=strict)


def verify_cost_model(model: EdgeCostModel, placement: Mapping[str, int],
                      strict: bool = False) -> List[Finding]:
    findings = check_cost_model(model, placement)
    return raise_findings(findings, CostCheckError,
                          "edge-cost model failed verification",
                          strict=strict)
