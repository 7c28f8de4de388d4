"""The numbers that decide ``correct`` for a training cell.

Both sides train the same weights on the same rows for the same first
steps.  Compared:

* ``loss_gap`` — the largest relative gap of a step's loss;
  ``loss_gap_first`` the first step's, before any update;
* ``grad_gap`` — over the leaves, the largest gap between the two sides'
  norms of the first step's gradient as AdamW gets it (the program's read
  from its first moment after one step, ``m / (1 - b1)``), over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap`` — the same for each leaf's change over the steps; a leaf
  whose reference gradient is under a thousandth of the median leaf's
  moves by round-off alone under AdamW and is left out;
* ``grad_gap_median``, ``change_gap_median`` — the median leaf's gap
  instead of the worst one: steady from seed to seed where a few leaves
  of an ill-conditioned step swing with the rounding;
* ``plan_diff`` — stages and compressed edges on which the program's plan
  and the reference's differ (an exact count; fusion cells only).

A cell's limits file names the numbers it compares.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Optional, Tuple

def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               skip=()) -> List[float]:
    """Each leaf's gap of norms over its own or the median leaf's norm."""
    if set(prog) != set(ref):
        return [math.inf]
    floor = median(ref.values())
    gaps = []
    for name, r in ref.items():
        if name not in skip:
            gap = abs(prog[name] - r) / max(r, floor, 1e-30)
            gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 n: int = 5) -> List[Tuple[str, float, float, float]]:
    """The ``n`` leaves of the largest gap: (leaf, gap, program's norm,
    reference's norm)."""
    floor = median(ref.values())
    rows = [(k, abs(prog[k] - r) / max(r, floor, 1e-30), prog[k], r)
            for k, r in ref.items() if k in prog]
    return sorted(rows, key=lambda row: -row[1])[:n]


def plan_diff(prog_plan: Tuple[List[List[str]], Dict[Tuple[str, str], float]],
              ref_plan: dict) -> int:
    stages, edges = prog_plan
    diff = sum(a != b for a, b in zip(stages, ref_plan["stages"]))
    diff += abs(len(stages) - len(ref_plan["stages"]))
    ref_edges = ref_plan["edges"]
    for e in set(edges) | set(ref_edges):
        if e not in edges or e not in ref_edges \
                or abs(edges[e] - ref_edges[e]) > 1e-9 * ref_edges[e]:
            diff += 1
    return diff


def numbers(prog: dict, ref: dict, plan: Optional[int] = None
            ) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "g1": {leaf: norm},
    "change": {leaf: norm}}."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    g_floor = median(ref["g1"].values())
    quiet = {n for n, g in ref["g1"].items() if g < 1e-3 * g_floor}
    grad = _leaf_gaps(prog["g1"], ref["g1"])
    change = _leaf_gaps(prog["change"], ref["change"], quiet)
    out = {"loss_gap": max(losses), "loss_gap_first": losses[0],
           "grad_gap": max(grad), "change_gap": max(change),
           "grad_gap_median": median(grad),
           "change_gap_median": median(change)}
    if plan is not None:
        out["plan_diff"] = float(plan)
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name is there, finite and within its
    limit."""
    return all(name in nums and math.isfinite(nums[name])
               and nums[name] <= limit for name, limit in limits.items())
