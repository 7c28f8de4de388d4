"""Top-K / AdaTopK communication compression (FusionLLM §5).

Top-K sparsification keeps the k largest-magnitude entries of a boundary
tensor (activation in FP, boundary gradient in BP); the receiver decodes by
scattering into zeros (paper Fig. 6).  Wire size for the paper's encoding is
``k·32 (values) + k·64 (indexes)`` bits = ``3·k·4`` bytes, i.e. with ratio
``r = d/k`` the payload shrinks to ``3/r`` of the original — the coefficient
3 in Eq. 7/8.

AdaTopK (Eq. 7) assigns *per-link* ratios so only the slowest links compress
hard::

    r_i = max(1, 3 r · R_i / max_p R_p)

**Break-even clamp** (bugfix over the paper's formula): the encoding has a
fixed per-kept-element overhead, so a ratio in ``(1, break_even]`` *inflates*
wire traffic instead of shrinking it — for the paper encoding
``k·(itemsize+8)`` bytes beat the dense ``d·itemsize`` only when
``r = d/k > (itemsize+8)/itemsize`` (3.0 at fp32, 5.0 at bf16 — the int64
index overhead amortizes over fewer payload bytes); for the mask encoding
``d/8 + k·itemsize ≤ d·itemsize`` requires ``r > itemsize/(itemsize−1/8)``.
:func:`adaptive_ratios` clamps any ratio at or below the encoding's
break-even to 1.0 (send dense), and :func:`plan_adatopk` additionally
verifies each planned edge with the exact integer :func:`wire_bytes` at the
producer's profile-derived itemsize (ceil(d/r) can tip a ratio just above
break-even back over the dense size, and a bf16 edge inflates where an fp32
edge would not), so no planned edge ever carries more bytes than the
uncompressed tensor.

Beyond-paper extras (both off by default, flagged where used):
* mask+values encoding — 1 bit/elem bitmap instead of int64 indexes
  (overhead ``(d/8 + 4k)/(4d)`` instead of ``3k/d``) — TPU-friendly since the
  decoded form stays dense;
* error-feedback memory (residual accumulation) for the gradient direction.

The hot inner op (`topk_mask`) dispatches through the kernel policy in
:mod:`repro_torch.kernels.ops` (``resolve_policy``, by the tensor's
device): ``use_kernel`` accepts ``False``/``"off"`` (global top-k — the
default), ``"auto"`` (the CUDA encode→decode kernels for a CUDA tensor,
their plain PyTorch versions for a CPU tensor — the same selection bit for
bit), and ``True``/``"force"`` (the CUDA kernels; a CPU tensor raises).
When a kernel mode is active the sparsified tensor is the decode of the
wire encode — the consumer sees exactly what the "mask" encoding carried.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

KernelPolicy = Union[bool, str, None]


# ------------------------------------------------------------- primitives --
def topk_select(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat Top-K by magnitude: returns (values, int32 indices), the paper's
    wire format, largest magnitude first.

    A stable descending sort of the magnitudes picks the set, so ties go to
    the lower index as they do under ``lax.top_k`` (``torch.topk`` is not
    index-stable on ties); one gather takes the signed payload.

    Wire-format note: indices are emitted as **int32** (boundary numel is
    far below 2^31), while ``wire_bytes(encoding="paper")`` still charges
    **8 bytes per index** to stay faithful to Eq. 7's int64 accounting —
    the byte model is deliberately conservative relative to this payload.
    """
    flat = x.reshape(-1)
    k = int(min(max(k, 1), flat.shape[0]))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32)


def topk_decode(values: torch.Tensor, idx: torch.Tensor,
                shape: Tuple[int, ...], dtype=None) -> torch.Tensor:
    """Scatter values back into zeros (paper Fig. 6 'Decoded Vector').

    ``dtype`` defaults to ``values.dtype`` so a bf16 boundary round-trips as
    bf16 — decoding must not silently upcast the wire payload."""
    if dtype is None:
        dtype = values.dtype
    flat = torch.zeros(int(np.prod(shape)), dtype=dtype, device=values.device)
    flat[idx.to(torch.int64)] = values.to(dtype)
    return flat.reshape(tuple(shape))


def topk_mask(x: torch.Tensor, k: int,
              use_kernel: KernelPolicy = False) -> torch.Tensor:
    """Dense sparsified tensor: x with everything below the k-th magnitude
    zeroed.  Semantically identical to select→decode, but stays dense (no
    scatter).

    ``use_kernel`` is the kernel dispatch policy (module docstring): any
    non-"global" mode routes through the wire codec
    (:func:`repro_torch.kernels.ops.codec_topk_mask`) — blockwise,
    tie-capped, wire-faithful."""
    from repro_torch.kernels import ops as _kops
    mode = _kops.resolve_policy(use_kernel, x.device)
    if mode != "global":
        return _kops.codec_topk_mask(x, k, mode=mode)
    flat = x.reshape(-1)
    k = int(min(max(k, 1), flat.shape[0]))
    mags = flat.abs()
    thresh = torch.topk(mags, k, sorted=True).values[-1]
    # Tie-break: if duplicates of the threshold magnitude would keep > k
    # entries, that is acceptable for convergence (superset of Top-K) and is
    # what a thresholding decoder observes; tests treat it as the oracle does.
    return torch.where(mags >= thresh, flat,
                       torch.zeros_like(flat)).reshape(x.shape)


def ratio_to_k(numel: int, ratio: float) -> int:
    """ratio r = d/k (paper: 'compression ratio 100' keeps 1%)."""
    if ratio <= 1.0:
        return int(numel)
    return max(1, int(np.ceil(numel / ratio)))


# ------------------------------------------------------------ wire models --
def wire_bytes(numel: int, ratio: float, encoding: str = "paper",
               itemsize: int = 4) -> float:
    """Bytes on the wire for one tensor under a ratio.

    ``itemsize`` is the boundary tensor's dtype width — the wire carries
    values at that width (:func:`topk_decode` preserves the wire dtype), so a
    bf16 edge pays 2 bytes per kept value, not a hard-coded 4.

    encoding='paper' : k·(itemsize values + 8 index) bytes  (Eq. 7 @ fp32)
    encoding='mask'  : k·itemsize + numel/8 bytes           (bitmap)
    encoding='none'  : numel·itemsize
    """
    if ratio <= 1.0 or encoding == "none":
        return float(numel * itemsize)
    k = ratio_to_k(numel, ratio)
    if encoding == "paper":
        return float(k * (itemsize + 8))
    if encoding == "mask":
        return float(k * itemsize + numel / 8.0)
    raise ValueError(f"unknown encoding {encoding!r}")


def dense_payload_bytes(x: torch.Tensor) -> float:
    """Dense in-memory bytes of a boundary tensor.  This is the sanctioned
    home for the ``numel·itemsize`` product — callers outside the cost-model
    layer (e.g. rad.py's kernel-timing hook) use this instead of inline
    itemsize arithmetic."""
    return float(x.numel() * x.element_size())


# --------------------------------------------------------------- AdaTopK ---
def encoding_break_even(encoding: str, itemsize: int = 4) -> float:
    """Smallest ratio at which the encoding stops inflating wire traffic.

    paper : k·(itemsize+8) vs dense d·itemsize → r > (itemsize+8)/itemsize
            (3.0 @ fp32, 5.0 @ bf16 — narrower dtypes pay the int64 index
            overhead over fewer payload bytes, so they break even later)
    mask  : k·itemsize + d/8 vs dense d·itemsize
            → r > itemsize/(itemsize − 1/8)
    none  : never compresses → +inf.
    """
    if encoding == "paper":
        return (itemsize + 8.0) / itemsize
    if encoding == "mask":
        return itemsize / (itemsize - 0.125)
    if encoding == "none":
        return float("inf")
    raise ValueError(f"unknown encoding {encoding!r}")


def adaptive_ratios(recv_times: Sequence[float], r: float,
                    index_overhead=3.0,
                    break_even=None) -> list:
    """Eq. 7 with a break-even clamp: per-CompNode ratio from estimated
    original communication times.

    r_i = overhead · r · R_i / max_p R_p.  CompNodes on fast links get
    r_i → 1 (no compression); the slowest link gets the full overhead·r.
    The paper's coefficient 3 is the fp32 paper-encoding overhead
    ``(itemsize+8)/itemsize``; both ``index_overhead`` and ``break_even``
    also accept a per-edge sequence so narrow dtypes (bf16: overhead 5) hit
    the requested wire-byte target instead of under-compressing at the fp32
    coefficient.  Any r_i at or below its ``break_even`` (default:
    ``index_overhead``, the encoding's per-element overhead factor) is
    clamped to 1.0 — the paper's ``max(1, ·)`` floor still pays the
    overhead per kept element, so ratios in ``(1, break_even]`` would
    *inflate* the wire payload.
    """
    if break_even is None:
        break_even = index_overhead
    R = np.asarray(list(recv_times), dtype=np.float64)
    oh = np.broadcast_to(np.asarray(index_overhead, dtype=np.float64),
                         R.shape)
    be = np.broadcast_to(np.asarray(break_even, dtype=np.float64), R.shape)
    mx = float(R.max()) if R.size else 0.0
    if mx <= 0.0:
        return [1.0 for _ in recv_times]
    raw = oh * r * R / mx
    return [float(ri) if ri > be_i else 1.0
            for ri, be_i in zip(raw, be)]


@dataclasses.dataclass
class CompressionPlan:
    """Broker-side plan: per cross-node edge (producer_op, consumer_op) the
    ratio to use, plus the encoding.  Built by :func:`plan_uniform` /
    :func:`plan_adatopk`; consumed by the executor, rad.py, and the
    throughput model (compress_cfg of OpData, §3.4)."""

    edge_ratio: Dict[Tuple[str, str], float]
    encoding: str = "paper"
    base_ratio: float = 1.0
    error_feedback: bool = False

    def ratio(self, producer: str, consumer: str) -> float:
        return self.edge_ratio.get((producer, consumer), 1.0)

    def as_mapping(self) -> Mapping[Tuple[str, str], float]:
        return self.edge_ratio


def _cross_edges(graph, placement: Mapping[str, int]):
    for n, node in graph.nodes.items():
        for a in node.args:
            if placement[a] != placement[n]:
                yield (a, n)


def plan_none(graph, placement) -> CompressionPlan:
    return CompressionPlan(edge_ratio={}, base_ratio=1.0, encoding="none")


def plan_uniform(graph, placement: Mapping[str, int], ratio: float,
                 encoding: str = "paper",
                 error_feedback: bool = False) -> CompressionPlan:
    """Uniform Top-K baseline: every cross-node edge compresses at r."""
    edges = {e: float(ratio) for e in _cross_edges(graph, placement)}
    return CompressionPlan(edge_ratio=edges, base_ratio=ratio,
                          encoding=encoding, error_feedback=error_feedback)


def plan_adatopk(graph, profiles, cluster, placement: Mapping[str, int],
                 ratio: float, encoding: str = "paper",
                 index_overhead: Optional[float] = None,
                 error_feedback: bool = False,
                 cost_model=None) -> CompressionPlan:
    """AdaTopK: Eq. 7 driven by the per-edge *dense* receive times — a thin
    policy over :class:`repro.core.costmodel.EdgeCostModel`.

    ``index_overhead=None`` (default) uses each edge's own encoding overhead
    factor ``(itemsize+8)/itemsize`` as Eq. 7's coefficient — exactly the
    paper's 3 for fp32 paper encoding, 5 for bf16 — so narrow dtypes hit the
    requested wire-byte target instead of under-compressing at the fp32
    coefficient.  Pass a number to force one uniform coefficient (the
    pre-dtype-aware knob).

    Ratios at or below their edge's dtype-exact break-even are clamped to
    1.0 (see module docstring), and every surviving edge is verified against
    the exact integer :func:`wire_bytes` at the producer's dtype —
    ``ceil(d/r)`` rounding can push a ratio just above break-even back over
    the dense payload.  The guarantee is hard: no planned edge carries more
    wire bytes than its dense tensor.

    If the cost model carries calibrated per-device kernel costs
    (``kernel_costs``), each surviving edge must also be *profitable*: the
    fused-encode compute seconds on the producer's codec stream must be
    strictly less than the link seconds the ratio saves, else the edge
    stays dense (FusionLLM §6's premise — compression must outrun the
    bandwidth it buys back).

    ``cost_model`` supplies the byte/seconds arithmetic (its own compression
    plan is ignored — AdaTopK rates links by their *uncompressed* transport
    time); by default a dense model over ``(graph, profiles, cluster)`` is
    built.
    """
    from .costmodel import EdgeCostModel   # late import: costmodel composes
    model = (cost_model or                 # this module's wire encodings
             EdgeCostModel(graph, profiles, cluster)).with_plan(None)
    edges = list(model.cross_edges(placement))
    if not edges:
        return CompressionPlan(edge_ratio={}, base_ratio=ratio,
                               encoding=encoding,
                               error_feedback=error_feedback)
    times = [model.link_seconds(placement[a], placement[n],
                                model.dense_bytes(a)) for (a, n) in edges]
    be_edge = [encoding_break_even(encoding, model.itemsize(a))
               for (a, n) in edges]
    overheads = be_edge if index_overhead is None \
        else [float(index_overhead)] * len(edges)
    ratios = adaptive_ratios(times, ratio, index_overhead=overheads,
                             break_even=be_edge)
    kernel_costs = getattr(model, "kernel_costs", None) or {}
    edge_ratio: Dict[Tuple[str, str], float] = {}
    for (a, n), r_i in zip(edges, ratios):
        if r_i <= 1.0:
            continue
        wire = wire_bytes(model.numel(a), r_i, encoding,
                          itemsize=model.itemsize(a))
        if wire >= model.dense_bytes(a):
            continue         # integer rounding re-inflated this edge
        kc = kernel_costs.get(placement[a])
        if kc is not None:
            # Profitability: the fused encode runs on the producer's codec
            # stream; if its compute time exceeds the wire seconds the
            # ratio saves on this link, compressing slows the step down.
            src, dst = placement[a], placement[n]
            dense = model.dense_bytes(a)
            saved = (model.link_seconds(src, dst, dense)
                     - model.link_seconds(src, dst, wire))
            if kc.seconds(dense) >= saved:
                continue
        edge_ratio[(a, n)] = r_i
    return CompressionPlan(edge_ratio=edge_ratio, base_ratio=ratio,
                           encoding=encoding, error_feedback=error_feedback)


# ------------------------------------------------- differentiable boundary --
class _BoundaryCompress(torch.autograd.Function):
    """FP transports Top-k_fwd(x); BP transports Top-k_bwd(grad)."""

    @staticmethod
    def forward(ctx, x, k_fwd, k_bwd, use_kernel):
        ctx.k_bwd = k_bwd
        ctx.use_kernel = use_kernel
        return topk_mask(x, k_fwd, use_kernel=use_kernel)

    @staticmethod
    def backward(ctx, g):
        return topk_mask(g, ctx.k_bwd, use_kernel=ctx.use_kernel), None, None, None


def boundary_compress(x: torch.Tensor, k_fwd: int, k_bwd: int,
                      use_kernel: KernelPolicy = False) -> torch.Tensor:
    """Lossy stage boundary: FP transports Top-k_fwd(x); BP transports
    Top-k_bwd(grad).  Matches the paper's RAD transport exactly — the
    receiving stage trains on the sparsified activation, the sending stage
    receives the sparsified boundary gradient.  0 < k ≥ numel disables.
    ``use_kernel`` is the kernel dispatch policy."""
    return _BoundaryCompress.apply(x, k_fwd, k_bwd, use_kernel)


def compress_for_edge(x: torch.Tensor, ratio: float,
                      use_kernel: KernelPolicy = False,
                      compress_bwd: bool = True) -> torch.Tensor:
    """Apply the plan's ratio to a concrete boundary tensor (k derived from
    its shape).  ``compress_bwd`` False leaves the cotangent dense (used by
    the error-feedback path, which compresses gradients itself,
    statefully)."""
    if ratio <= 1.0:
        return x
    numel = x.numel()
    k = ratio_to_k(numel, ratio)
    return boundary_compress(x, k, k if compress_bwd else numel, use_kernel)


# ----------------------------------------------------------- error feedback --
@dataclasses.dataclass
class ErrorFeedbackState:
    """Residual memory per edge (beyond-paper; standard EF-SGD trick)."""

    residual: Any  # tensor matching the boundary tensor

    @staticmethod
    def init(example: torch.Tensor) -> "ErrorFeedbackState":
        return ErrorFeedbackState(residual=torch.zeros_like(example))


def ef_compress(x: torch.Tensor, state: ErrorFeedbackState, k: int,
                use_kernel: KernelPolicy = False
                ) -> Tuple[torch.Tensor, ErrorFeedbackState]:
    """Compress (x + residual); remember what was dropped.

    Under a kernel dispatch mode the residual update belongs to the fused
    encode kernel ``ef_encode_topk``, then the decode
    (:func:`repro_torch.kernels.ops.codec_ef_topk`): the CUDA kernels for a
    CUDA tensor, their plain versions for a CPU tensor.  The result equals,
    bit for bit, what the EF training step composes from ``x + residual``,
    the codec ``topk_mask`` and the difference."""
    from repro_torch.kernels import ops as _kops
    mode = _kops.resolve_policy(use_kernel, x.device)
    if mode != "global":
        sent, newr = _kops.codec_ef_topk(x, state.residual, k, mode=mode)
        return sent, ErrorFeedbackState(residual=newr)
    corrected = x + state.residual
    sent = topk_mask(corrected, k, use_kernel=False)
    return sent, ErrorFeedbackState(residual=corrected - sent)
