"""Static HLO-text analysis: collective traffic accounting.

The port compiles no HLO: this module reads the compiled module text the
JAX package's dry run saves (``--save-hlo``), and its numbers feed
:func:`repro_torch.analysis.roofline.roofline_terms`.  XLA's
``cost_analysis()`` gives FLOPs/bytes but (a) omits collective traffic and
(b) counts a while-loop body once regardless of trip count.  This module
parses the module text:

* every computation's collective ops (all-gather / all-reduce /
  reduce-scatter / all-to-all / collective-permute) with operand byte sizes;
* the computation call graph (while body/condition, fusion calls, to_apply);
* best-effort while trip counts (largest integer constant in the loop
  condition computation — exact for ``lax.scan``'s canonical counter);

and returns collective bytes with each computation weighted by the product
of trip counts on its call path.  The same multiplier machinery corrects
FLOPs/bytes from per-body cost analyses in the roofline harness.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(tok: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(tok):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class Computation:
    name: str
    lines: List[str]
    collective_bytes: float = 0.0
    calls: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    # (callee_name, kind) kind in {"while_body", "while_cond", "call"}


_COLL_RE = re.compile(
    r"=\s*(?P<result>.*?)\s(?P<op>(?:%s)(?:-start|-done)?)\("
    % "|".join(_COLLECTIVES))


def _collective_line_bytes(line: str) -> Tuple[Optional[str], float]:
    """(kind, bytes) for a collective instruction line, else (None, 0).

    This HLO dialect prints operands without shapes, so we charge the
    RESULT shape — a consistent per-op traffic proxy (all-reduce moves ~2×
    this on a ring, all-gather ~(g-1)/g of it).  Async ``-done`` halves
    are skipped to avoid double counting.
    """
    m = _COLL_RE.search(line)
    if not m:
        return None, 0.0
    op = m.group("op")
    if op.endswith("-done"):
        return None, 0.0
    kind = op.replace("-start", "")
    return kind, float(_shape_bytes(m.group("result")))


def parse_hlo_computations(text: str) -> Dict[str, Computation]:
    """Split module text into computations and extract collectives + calls."""
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for raw in text.splitlines():
        line = raw.strip()
        if line.endswith("{") and "->" in line and "=" not in line.split(
                "(", 1)[0]:
            name = line.split("(", 1)[0].strip()
            if name.startswith("ENTRY"):
                name = name[len("ENTRY"):].strip()
            cur = Computation(name=name.lstrip("%"), lines=[])
            comps[cur.name] = cur
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is None:
            continue
        cur.lines.append(line)
        _, nbytes = _collective_line_bytes(line)
        cur.collective_bytes += nbytes
        for wm in re.finditer(r"condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)",
                              line):
            cur.calls.append((wm.group(1), "while_cond"))
            cur.calls.append((wm.group(2), "while_body"))
        for cm in re.finditer(r"(?:calls|to_apply)=%?([\w\.\-]+)", line):
            cur.calls.append((cm.group(1), "call"))
    return comps


def while_trip_counts(comps: Dict[str, Computation]) -> Dict[str, int]:
    """body computation name -> inferred trip count (1 if unknown)."""
    trips: Dict[str, int] = {}
    for comp in comps.values():
        for line in comp.lines:
            wm = re.search(r"condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)",
                           line)
            if not wm:
                continue
            cond, body = wm.group(1), wm.group(2)
            trip = 1
            cc = comps.get(cond)
            if cc:
                consts = [int(x) for l in cc.lines
                          for x in re.findall(r"constant\((\d+)\)", l)]
                if consts:
                    trip = max(consts)
            trips[body] = max(trips.get(body, 1), trip)
    return trips


def _multipliers(comps: Dict[str, Computation]) -> Dict[str, float]:
    """Multiplicity of each computation = product of trip counts along the
    call chain from the entry."""
    trips = while_trip_counts(comps)
    # find entry: computation not called by anyone
    called = {callee for c in comps.values() for callee, _ in c.calls}
    entries = [c.name for c in comps.values() if c.name not in called]
    mult: Dict[str, float] = {}

    def visit(name: str, m: float):
        if name not in comps:
            return
        mult[name] = mult.get(name, 0.0) + m
        for callee, kind in comps[name].calls:
            child_m = m * trips.get(callee, 1) if kind == "while_body" else \
                (0.0 if kind == "while_cond" else m)
            if kind == "while_cond":
                child_m = m  # condition runs trip+1 times ~ trip; negligible
            visit(callee, child_m)

    for e in entries:
        visit(e, 1.0)
    return mult


def collective_bytes(text: str) -> float:
    """Total collective operand bytes, while-loop bodies weighted by trip
    count."""
    comps = parse_hlo_computations(text)
    mult = _multipliers(comps)
    return float(sum(c.collective_bytes * mult.get(c.name, 1.0)
                     for c in comps.values()))


def collective_breakdown(text: str) -> Dict[str, float]:
    """Per-collective-kind byte totals (trip-weighted)."""
    comps = parse_hlo_computations(text)
    mult = _multipliers(comps)
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for c in comps.values():
        m = mult.get(c.name, 1.0)
        for line in c.lines:
            kind, nbytes = _collective_line_bytes(line)
            if kind:
                out[kind] += nbytes * m
    return out
