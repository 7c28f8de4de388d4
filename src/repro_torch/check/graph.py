"""OP-DAG structural checks (repro_torch.check, component 1).

Validates the graph invariants everything downstream assumes:

* acyclicity (Kahn's algorithm; cycle members named),
* no dangling or duplicate deps,
* shape/dtype inference consistency along every edge,
* every compute op reachable *from the loss* along reverse edges —
  an op no gradient can flow to silently trains nothing.

All checks return :class:`repro_torch.check.errors.Finding` lists;
:func:`verify_graph` raises :class:`GraphCheckError`.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.opgraph import OpGraph, OpProfile, OpType

from .errors import (Finding, GraphCheckError, SEV_WARN, raise_findings)

Shape = Tuple[int, ...]


def _dep_findings(graph: OpGraph) -> List[Finding]:
    out: List[Finding] = []
    for n, node in graph.nodes.items():
        seen: set = set()
        for a in node.args:
            if a not in graph.nodes:
                out.append(Finding("dangling-dep", n,
                                   f"op {n!r} depends on absent op {a!r}"))
            elif a in seen:
                out.append(Finding("duplicate-dep", n,
                                   f"op {n!r} lists dep {a!r} twice"))
            seen.add(a)
        if n != node.name:
            out.append(Finding("name-key-mismatch", n,
                               f"node keyed {n!r} but named {node.name!r}"))
    return out


def _cycle_findings(graph: OpGraph) -> List[Finding]:
    """Kahn's over the known-dep subgraph; leftover nodes sit on a cycle."""
    known = set(graph.nodes)
    indeg = {n: sum(1 for a in graph.nodes[n].args if a in known)
             for n in known}
    users: Dict[str, List[str]] = {n: [] for n in known}
    for n, node in graph.nodes.items():
        for a in node.args:
            if a in known:
                users[a].append(n)
    ready = [n for n in graph.nodes if indeg[n] == 0]
    done = 0
    while ready:
        n = ready.pop(0)
        done += 1
        for u in users[n]:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    if done == len(graph.nodes):
        return []
    stuck = sorted(n for n in graph.nodes if indeg[n] > 0)
    return [Finding("cycle", stuck[0] if stuck else "<graph>",
                    f"OP-DAG contains a cycle through {stuck}")]


def _reachability_findings(graph: OpGraph) -> List[Finding]:
    """Compute ops from which no path reaches a loss node get no gradient.
    Graphs without a LOSS node (inference graphs) skip this check."""
    losses = graph.loss_nodes()
    if not losses:
        return []
    # ancestors-of-loss via reverse BFS over args
    reach = set(losses)
    frontier = list(losses)
    while frontier:
        n = frontier.pop()
        for a in graph.nodes[n].args:
            if a in graph.nodes and a not in reach:
                reach.add(a)
                frontier.append(a)
    out: List[Finding] = []
    for n, node in graph.nodes.items():
        if n in reach:
            continue
        sev = SEV_WARN if node.op_type in (OpType.PLACEHOLDER,
                                           OpType.VARIABLE) else "error"
        out.append(Finding("unreachable-from-loss", n,
                           f"op {n!r} ({node.op_type.value}) has no path "
                           f"to any loss node {losses}", severity=sev))
    return out


def _shape_findings(graph: OpGraph,
                    input_shapes: Mapping[str, Shape]) -> List[Finding]:
    out: List[Finding] = []
    shapes: Dict[str, Shape] = {}
    try:
        order = graph.topo_order()
    except ValueError:
        return out      # cycle already reported; inference cannot run
    for n in order:
        node = graph.nodes[n]
        try:
            if node.op_type is OpType.PLACEHOLDER:
                if n not in input_shapes:
                    out.append(Finding("missing-input-shape", n,
                                       f"placeholder {n!r} has no entry in "
                                       "input_shapes"))
                    continue
                shapes[n] = tuple(input_shapes[n])
            elif node.op_type is OpType.VARIABLE:
                shapes[n] = tuple(node.meta["shape"])
            else:
                ins = [shapes[a] for a in node.args if a in shapes]
                if len(ins) != len(node.args):
                    continue     # upstream already failed
                shapes[n] = node.infer_out_shape(*ins)
        except (KeyError, ValueError, TypeError) as e:
            out.append(Finding("shape-inference", n,
                               f"op {n!r}: shape inference failed: {e}"))
            continue
        shp = shapes.get(n)
        if shp is not None and not all(
                isinstance(d, (int, np.integer)) and d >= 0 for d in shp):
            out.append(Finding("bad-shape", n,
                               f"op {n!r} inferred shape {shp!r} is not a "
                               "tuple of non-negative ints"))
        try:
            np.dtype(node.out_dtype)
        except TypeError:
            out.append(Finding("bad-dtype", n,
                               f"op {n!r} out_dtype {node.out_dtype!r} is "
                               "not a valid dtype"))
    return out


def check_graph(graph: OpGraph,
                input_shapes: Optional[Mapping[str, Shape]] = None
                ) -> List[Finding]:
    """All structural graph checks; shape checks only when
    ``input_shapes`` is supplied."""
    findings = _dep_findings(graph)
    findings += _cycle_findings(graph)
    if not findings:   # reachability over a broken edge set is noise
        findings += _reachability_findings(graph)
    if input_shapes is not None and not findings:
        findings += _shape_findings(graph, input_shapes)
    return findings


def check_profiles(graph: OpGraph, profiles: Mapping[str, OpProfile],
                   input_shapes: Optional[Mapping[str, Shape]] = None
                   ) -> List[Finding]:
    """Broker-side :class:`OpProfile` consistency: every op profiled, all
    numbers finite and non-negative, ``out_bytes`` an integral itemsize
    multiple of the shape's numel, and (when ``input_shapes`` is given)
    the profiled shape equal to the freshly inferred one."""
    out: List[Finding] = []
    inferred: Optional[Dict[str, Shape]] = None
    if input_shapes is not None:
        try:
            inferred = graph.infer_shapes(input_shapes)
        except ValueError:
            inferred = None    # reported by check_graph
    for n in graph.nodes:
        p = profiles.get(n)
        if p is None:
            out.append(Finding("missing-profile", n,
                               f"op {n!r} has no OpProfile"))
            continue
        for field, v in (("fwd_flops", p.fwd_flops),
                         ("out_bytes", p.out_bytes),
                         ("n_params", p.n_params)):
            if not np.isfinite(v) or v < 0:
                out.append(Finding("bad-profile-value", n,
                                   f"op {n!r} profile {field}={v!r} must be "
                                   "finite and >= 0"))
        numel = int(np.prod(p.out_shape)) if p.out_shape else 0
        if numel > 0 and p.out_bytes > 0:
            item = p.out_bytes / numel
            if abs(item - round(item)) > 1e-9 or not 1 <= round(item) <= 32:
                out.append(Finding(
                    "profile-bytes-inconsistent", n,
                    f"op {n!r} out_bytes={p.out_bytes} over numel={numel} "
                    f"gives itemsize {item:.3g}, not an integer in [1, 32]"))
        if inferred is not None and n in inferred \
                and tuple(p.out_shape) != tuple(inferred[n]):
            out.append(Finding(
                "profile-shape-mismatch", n,
                f"op {n!r} profiled shape {tuple(p.out_shape)} != inferred "
                f"{tuple(inferred[n])}"))
    return out


def verify_graph(graph: OpGraph,
                 input_shapes: Optional[Mapping[str, Shape]] = None,
                 profiles: Optional[Mapping[str, OpProfile]] = None,
                 strict: bool = False) -> List[Finding]:
    """Raise :class:`GraphCheckError` on any error-severity finding
    (``strict=True`` promotes warnings too); returns the findings."""
    findings = check_graph(graph, input_shapes)
    if profiles is not None:
        findings += check_profiles(graph, profiles, input_shapes)
    return raise_findings(findings, GraphCheckError,
                          f"OP-DAG {graph.name!r} failed verification",
                          strict=strict)
