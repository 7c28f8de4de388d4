"""Bit-exact state migration (elastic runtime).

A re-plan moves op segments between CompNodes; each move ships the op's
parameters and optimizer state.  The payload travels in the checkpoint
subsystem's wire format (:func:`repro_torch.checkpoint.serialize_state` — the
same flattened-path .npz envelope as on-disk checkpoints, held in memory),
so a migration is numerically identical to a checkpoint round-trip:
restored state is bit-exact, and the loss curve is continuous across a
fail-over (tested).

Optimizer-state layout is handled structurally: the repo's ``OptState``
holds either a per-op mapping (SGD momentum, Adafactor) or a mapping of
accumulators each keyed per-op (AdamW's ``{"m": {op: ...}, "v": ...}``);
:func:`extract_op_state` slices both shapes by op name.

Migration payloads are deliberately exempt from AdaTopK: Top-K loss on a
boundary activation is absorbed by training, Top-K loss on the weights
themselves is corruption.

Both migration modes go through :func:`apply_moves`: stop-the-world applies
the whole plan at once; overlapped migration applies the blocking
(checkpoint-restore) moves implicitly via the rollback restore, then the
background survivor moves at cut-over — in either case the wire round-trip
is bit-exact, so a loss curve is continuous across the hand-off.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import torch

from repro_torch.checkpoint import deserialize_state, serialize_state
from repro_torch.obs.trace import CAT_CHECKPOINT, CAT_MIGRATION
from .replan import OpMove


# ------------------------------------------------------------- tree slicing
def _extract_inner(inner: Any, ops: Set[str], op_names: Set[str]) -> Any:
    """Slice an optimizer inner-state tree down to ``ops``.

    Layouts: ``None`` (plain SGD); ``{op: state}`` (momentum/Adafactor);
    ``{acc: {op: state}}`` (AdamW moments).  The per-op level is recognized
    by key overlap with the model's op names.
    """
    if inner is None or not isinstance(inner, Mapping):
        return inner
    if set(inner) & op_names:
        return {k: v for k, v in inner.items() if k in ops}
    return {k: _extract_inner(v, ops, op_names) for k, v in inner.items()}


def _merge_inner(inner: Any, sub: Any, op_names: Set[str]) -> Any:
    """Write a slice produced by :func:`_extract_inner` back into ``inner``."""
    if inner is None or not isinstance(inner, Mapping):
        return inner
    if set(inner) & op_names:
        out = dict(inner)
        out.update(sub or {})
        return out
    return {k: _merge_inner(v, (sub or {}).get(k), op_names)
            for k, v in inner.items()}


def extract_op_state(params: Mapping[str, Any], opt_state: Any,
                     ops: Sequence[str]) -> Tuple[Dict[str, Any], Any]:
    """The (params, opt) sub-trees owned by ``ops`` (ops without trainable
    state are skipped — nothing to ship)."""
    op_set = set(ops)
    op_names = set(params)
    p_sub = {k: v for k, v in params.items() if k in op_set}
    o_sub = None
    if opt_state is not None:
        inner = _extract_inner(opt_state.inner, op_set, op_names)
        o_sub = opt_state._replace(inner=inner)
    return p_sub, o_sub


def pack_op_state(params: Mapping[str, Any], opt_state: Any,
                  ops: Sequence[str]) -> bytes:
    """One migration envelope: the ops' state in checkpoint wire format."""
    p_sub, o_sub = extract_op_state(params, opt_state, ops)
    return serialize_state(p_sub, o_sub)


def unpack_op_state(blob: bytes, params: Mapping[str, Any], opt_state: Any,
                    ops: Sequence[str]) -> Tuple[Dict[str, Any], Any]:
    """Decode an envelope using the live state as structure template."""
    p_t, o_t = extract_op_state(params, opt_state, ops)
    return deserialize_state(blob, p_t, o_t)


# ---------------------------------------------------------------- outcomes
@dataclasses.dataclass
class MigrationOutcome:
    params: Dict[str, Any]
    opt_state: Any
    wire_bytes: int              # actual serialized envelope bytes
    n_envelopes: int


def apply_moves(params: Mapping[str, Any], opt_state: Any,
                moves: Sequence[OpMove],
                trace: Optional[Any] = None) -> MigrationOutcome:
    """Execute a migration plan: one envelope per (src, dst) link, each op's
    state serialized, shipped, and restored through the checkpoint format.

    The single-process runtime holds the global state either way — what this
    proves (and the controller relies on) is that the wire round-trip is
    bit-exact, so a multi-process deployment of the same envelopes would
    reconstruct identical numerics.

    ``trace`` (a :class:`repro_torch.obs.trace.TraceRecorder`) records one
    wall-clock span per envelope: ``checkpoint.restore`` for streams out of
    the broker's store (``src=None``), ``migrate.stream`` for peer-to-peer
    transfers, args carrying exact envelope bytes and op count.
    """
    groups: Dict[Tuple[Optional[int], int], List[str]] = {}
    for m in moves:
        groups.setdefault((m.src, m.dst), []).append(m.op)
    tracer = trace if getattr(trace, "enabled", False) else None

    new_params = dict(params)
    new_opt = opt_state
    op_names = set(params)
    wire = 0
    n_env = 0
    for key in sorted(groups, key=lambda k: (k[0] is None, k)):
        ops = [o for o in groups[key] if o in params]
        if not ops:
            continue
        src, dst = key
        token = None
        if tracer is not None:
            lbl = f"{'ckpt' if src is None else src}->{dst}"
            token = tracer.begin(
                CAT_CHECKPOINT if src is None else CAT_MIGRATION,
                lbl, f"migrate {lbl}", args={"n_ops": len(ops)})
        blob = pack_op_state(params, opt_state, ops)
        wire += len(blob)
        n_env += 1
        p_sub, o_sub = unpack_op_state(blob, params, opt_state, ops)
        if tracer is not None:
            tracer.end(token, args={"nbytes": len(blob)})
        new_params.update(p_sub)
        if new_opt is not None and o_sub is not None:
            new_opt = new_opt._replace(
                inner=_merge_inner(new_opt.inner, o_sub.inner, op_names))
    return MigrationOutcome(params=new_params, opt_state=new_opt,
                            wire_bytes=wire, n_envelopes=n_env)


# -------------------------------------------------------------- bit checks
def _structure(tree: Any, leaves: List[Any]) -> Any:
    """The tree's structure as a comparable value (``jax.tree_util``'s
    treedef: dict keys, named-tuple types, sequence lengths, ``None``
    holes); appends the leaves to ``leaves`` in flattening order."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_structure(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_structure(v, leaves) for v in tree))
    leaves.append(tree)
    return "*"


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _leaves_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """``np.array_equal(x, y, equal_nan=True)`` for two tensors of one dtype
    and shape: equal storage bits decide at once; otherwise the values
    (``-0.0 == 0.0``, any NaN equal to any NaN)."""
    y = y.to(x.device)
    if not (x.is_floating_point() or x.is_complex()):
        return torch.equal(x, y)
    view = _INT_VIEW.get(x.element_size())
    if view is not None and torch.equal(x.view(view), y.view(view)):
        return True
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def trees_bitexact(a: Any, b: Any) -> bool:
    la: List[Any] = []
    lb: List[Any] = []
    if _structure(a, la) != _structure(b, lb) or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not _leaves_equal(x, y):
            return False
    return True


def assert_bitexact(a: Any, b: Any, what: str = "state") -> None:
    if not trees_bitexact(a, b):
        raise AssertionError(f"{what} not bit-exact across migration")
