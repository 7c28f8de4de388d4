"""Remote automatic differentiation (FusionLLM §3.3).

No ML framework differentiates across machine boundaries; FusionLLM's answer
is stage-local autodiff plus boundary exchange: every CompNode runs FP/BP on
its own sub-DAG and only boundary activations (FP) and boundary gradients
(BP, keyed ``producer->user``) travel between CompNodes.

PyTorch mapping: each sub-DAG becomes a function
``f_k(params_k, ext_acts, inputs) -> (sends, loss_k)``.  The forward sweep
runs each stage under autograd on fresh leaf tensors (its parameters and
the activations it received) and records a backward closure over the
stage's graph; the backward sweep calls the closures in reverse
(``torch.autograd.grad``), routing each cotangent back over the edge it
belongs to.  Compression (AdaTopK) is applied to the transported tensor on
both directions of every cross-node edge — on detached tensors, outside any
stage's graph, exactly like the real transport (the consumer trains on the
sparsified activation; the producer backpropagates the sparsified
gradient).

``pipeline_loss_and_grad`` with no compression matches single-device
autograd over :meth:`OpGraph.apply` (tested), which is the correctness
contract of RAD.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .compression import (CompressionPlan, KernelPolicy, compress_for_edge,
                          dense_payload_bytes, plan_none)
from .opgraph import OpGraph, OpType, SubDag, tree_leaves
from ..obs.trace import CAT_ENCODE


Params = Mapping[str, Any]

# Measured-wall-clock hook: (stage_index, backward, seconds) per stage call.
# The DecentralizedRuntime wraps this into StepTiming telemetry samples.
TimingCb = Callable[[int, bool, float], None]

# Measured-wall-clock codec hook: (stage_index, backward, seconds,
# dense_bytes) per compressed boundary edge.  The DecentralizedRuntime wraps
# this into KernelTiming telemetry samples — the raw material of
# fit_kernel_costs calibration.
KernelCb = Callable[[int, bool, float, float], None]


def _sync(tensors) -> None:
    """Wait for the device work behind ``tensors`` (CUDA launches return
    before the work runs), so a wall-clock sample measures execution, not
    dispatch."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in tree_leaves(tensors)):
        torch.cuda.synchronize()


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts with matching keys."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in first}
    return fn(*trees)


def _leaf_params(tree):
    """A copy of ``tree`` whose tensors are fresh autograd leaves sharing
    storage with the originals."""
    return tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), tree)


def _traced_compress(trace, name: str, track: str, backward: bool,
                     ratio: float, fn, kernel_cb: Optional[KernelCb] = None,
                     stage: int = 0, dense_bytes: float = 0.0):
    """Run one boundary compression, recording a wall-clock encode span when
    tracing and a ``kernel_cb`` timing sample when instrumented.  The decode
    half is fused into the same op (a kernel-dispatched topk_mask is
    encode→decode of the wire format), so both cover the whole codec;
    ``ratio<=1`` edges transport dense and record nothing."""
    traced = trace is not None and getattr(trace, "enabled", False)
    if ratio <= 1.0 or (not traced and kernel_cb is None):
        return fn()
    t0 = time.perf_counter() if kernel_cb is not None else 0.0
    if traced:
        with trace.region(CAT_ENCODE, name, track,
                          args={"ratio": ratio, "backward": backward}):
            out = fn()
            _sync(out)
    else:
        out = fn()
        _sync(out)
    if kernel_cb is not None:
        kernel_cb(stage, backward, time.perf_counter() - t0, dense_bytes)
    return out


def make_stage_fn(graph: OpGraph, subdag: SubDag
                  ) -> Callable[[Params, Mapping[str, torch.Tensor],
                                 Mapping[str, torch.Tensor]],
                                Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Build the function executed by one CompNode.

    Args: ``params`` for this sub-DAG's parametric ops; ``ext_acts`` —
    activations received from other CompNodes (keys = producer op names,
    i.e. ``subdag.required_acti``); ``inputs`` — placeholder/variable values
    owned by this sub-DAG.  Returns (sends, loss) where ``sends`` maps each
    ``send_acti`` op name to its output and ``loss`` sums this sub-DAG's loss
    nodes (0.0 if none).
    """
    topo = [n for n in graph.topo_order() if n in subdag.node_set]

    def stage_fn(params: Params, ext_acts: Mapping[str, torch.Tensor],
                 inputs: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        vals: Dict[str, torch.Tensor] = dict(ext_acts)
        loss = None
        for n in topo:
            node = graph.nodes[n]
            if node.op_type in (OpType.PLACEHOLDER, OpType.VARIABLE):
                vals[n] = inputs[n]
                continue
            args = [vals[a] for a in node.args]
            out = node.apply_fn(params.get(n), *args) if node.apply_fn else args[0]
            vals[n] = out
            if node.op_type is OpType.LOSS:
                term = torch.sum(out).to(torch.float32)
                loss = term if loss is None else loss + term
        if loss is None:
            dev = next(iter(vals.values())).device if vals else None
            loss = torch.zeros((), dtype=torch.float32, device=dev)
        sends = {n: vals[n] for n in subdag.send_acti}
        return sends, loss

    return stage_fn


@dataclasses.dataclass
class PipelineProgram:
    """Compiled stage plan: stage functions in pipeline order plus routing
    tables (which stage consumes which producer's output)."""

    graph: OpGraph
    subdags: List[SubDag]
    stage_fns: List[Callable]
    # consumer routing: producer op -> list of (consumer_stage_idx)
    consumers: Dict[str, List[int]]
    owner_stage: Dict[str, int]

    @staticmethod
    def build(graph: OpGraph, subdags: Sequence[SubDag]) -> "PipelineProgram":
        subdags = list(subdags)
        owner: Dict[str, int] = {}
        for si, sd in enumerate(subdags):
            for n in sd.node_names:
                owner[n] = si
        consumers: Dict[str, List[int]] = {}
        for si, sd in enumerate(subdags):
            for a in sd.required_acti:
                consumers.setdefault(a, []).append(si)
        return PipelineProgram(
            graph=graph, subdags=subdags,
            stage_fns=[make_stage_fn(graph, sd) for sd in subdags],
            consumers=consumers, owner_stage=owner)

    def split_params(self, params: Params) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = [{} for _ in self.subdags]
        for name, p in params.items():
            out[self.owner_stage[name]][name] = p
        return out

    def split_inputs(self, inputs: Mapping[str, torch.Tensor],
                     variables: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> List[Dict[str, torch.Tensor]]:
        merged = dict(inputs)
        merged.update(variables or {})
        out: List[Dict[str, torch.Tensor]] = [{} for _ in self.subdags]
        for si, sd in enumerate(self.subdags):
            for n in sd.node_names:
                node = self.graph.nodes[n]
                if node.op_type in (OpType.PLACEHOLDER, OpType.VARIABLE):
                    out[si][n] = merged[n]
        return out


def _cotangents(wrt, grads):
    """Lookup from a leaf tensor to its gradient, zeros where autograd
    found none (unused or not differentiable)."""
    by_id = {id(t): g for t, g in zip(wrt, grads)}

    def cot(t):
        g = by_id.get(id(t))
        return torch.zeros_like(t) if g is None else g
    return cot


class StageVjp:
    """The backward closure of one stage's forward (the counterpart of the
    closure ``jax.vjp`` returns): holds the stage's autograd graph until it
    is called once with ``(sends_cot, loss_cot)`` and returns
    ``(param_cotangents, ext_cotangents)``.  Unused inputs get zeros."""

    def __init__(self, params, ext, sends, loss):
        self.params, self.ext, self.sends, self.loss = params, ext, sends, loss

    def __call__(self, cotangents):
        sends_cot, loss_cot = cotangents
        outs, cots = [], []
        for a, out in self.sends.items():
            if out.requires_grad:
                outs.append(out)
                cots.append(sends_cot[a].to(out.dtype))
        if self.loss.requires_grad:
            outs.append(self.loss)
            cots.append(torch.as_tensor(loss_cot, dtype=self.loss.dtype,
                                        device=self.loss.device))
        p_leaves = tree_leaves(self.params)
        e_keys = list(self.ext)
        wrt = [t for t in p_leaves + [self.ext[a] for a in e_keys]
               if t.requires_grad]
        grads = (torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                 if outs and wrt else [None] * len(wrt))
        cot = _cotangents(wrt, grads)
        p_cot = tree_map(cot, self.params)
        ext_cot = {a: cot(self.ext[a]) for a in e_keys}
        self.params = self.ext = self.sends = self.loss = None
        return p_cot, ext_cot


def pipeline_forward(prog: PipelineProgram, params: Params,
                     inputs: Mapping[str, torch.Tensor],
                     plan: Optional[CompressionPlan] = None,
                     use_kernel: KernelPolicy = False,
                     compress_bwd: bool = True,
                     timing_cb: Optional[TimingCb] = None,
                     trace: Optional[Any] = None,
                     kernel_cb: Optional[KernelCb] = None
                     ) -> Tuple[torch.Tensor, List[StageVjp],
                                List[Dict[str, torch.Tensor]]]:
    """Forward sweep.  Returns (total_loss, backward closures per stage, the
    per-stage received ext_acts — needed to key backward cotangents).
    ``timing_cb(stage, backward=False, seconds)`` receives each stage's
    measured host wall-clock (telemetry hook; None = no instrumentation);
    ``trace`` additionally records wall-clock ``compress.encode`` spans per
    compressed boundary edge; ``kernel_cb(stage, backward, seconds,
    dense_bytes)`` receives each compressed edge's measured codec time."""
    plan = plan or plan_none(prog.graph, prog.owner_stage)
    stage_params = prog.split_params(params)
    stage_inputs = prog.split_inputs(inputs)
    mailbox: Dict[Tuple[str, int], torch.Tensor] = {}  # (producer, consumer_stage)
    vjps: List[StageVjp] = []
    received: List[Dict[str, torch.Tensor]] = []
    total_loss = None

    for si, (fn, sd) in enumerate(zip(prog.stage_fns, prog.subdags)):
        ext = {a: mailbox[(a, si)] for a in sd.required_acti}
        received.append(ext)
        t0 = time.perf_counter() if timing_cb else 0.0
        p_leaf = _leaf_params(stage_params[si])
        e_leaf = {a: v.detach().requires_grad_(v.is_floating_point())
                  for a, v in ext.items()}
        with torch.enable_grad():
            sends, loss = fn(p_leaf, e_leaf, stage_inputs[si])
        if timing_cb:
            _sync((sends, loss))
            timing_cb(si, False, time.perf_counter() - t0)
        vjps.append(StageVjp(p_leaf, e_leaf, sends, loss))
        loss = loss.detach()
        total_loss = loss if total_loss is None else total_loss + loss
        # transport: compress per edge (producer -> each consumer stage link)
        for a, out in sends.items():
            out = out.detach()
            for cj in prog.consumers.get(a, []):
                consumer_ops = [n for n in prog.subdags[cj].node_names
                                if a in prog.graph.nodes[n].args]
                # one physical message per (producer, consumer CompNode); the
                # plan is keyed per (producer op, consumer op) — same ratio
                # for all consumers on one CompNode by construction.
                ratio = max([plan.ratio(a, c) for c in consumer_ops] or [1.0])
                mailbox[(a, cj)] = _traced_compress(
                    trace, f"enc {a}->s{cj}", f"stage{si}", False, ratio,
                    lambda out=out, ratio=ratio: compress_for_edge(
                        out, ratio, use_kernel, compress_bwd),
                    kernel_cb=kernel_cb, stage=si,
                    dense_bytes=dense_payload_bytes(out))
    return total_loss, vjps, received


def pipeline_backward(prog: PipelineProgram, vjps: List[StageVjp],
                      received: List[Dict[str, torch.Tensor]],
                      plan: Optional[CompressionPlan] = None,
                      use_kernel: KernelPolicy = False,
                      timing_cb: Optional[TimingCb] = None,
                      trace: Optional[Any] = None,
                      kernel_cb: Optional[KernelCb] = None) -> Dict[str, Any]:
    """Backward sweep in reverse stage order; boundary gradients are
    compressed on the same links as their forward activations."""
    plan = plan or plan_none(prog.graph, prog.owner_stage)
    n_stages = len(prog.subdags)
    # cotangents awaiting each stage's sends, keyed by producer op
    grad_mail: Dict[str, torch.Tensor] = {}
    grads: Dict[str, Any] = {}

    for si in range(n_stages - 1, -1, -1):
        sd = prog.subdags[si]
        sends_cot = {}
        for a in sd.send_acti:
            g = grad_mail.get(a)
            if g is None:
                raise RuntimeError(f"missing boundary gradient for {a!r}")
            sends_cot[a] = g
        t0 = time.perf_counter() if timing_cb else 0.0
        p_cot, ext_cot = vjps[si]((sends_cot, 1.0))
        if timing_cb:
            _sync((p_cot, ext_cot))
            timing_cb(si, True, time.perf_counter() - t0)
        grads.update(p_cot)
        # route ext cotangents back to producers, compressed per link
        for a, g in ext_cot.items():
            producer_ops_here = [n for n in sd.node_names
                                 if a in prog.graph.nodes[n].args]
            ratio = max([plan.ratio(a, c) for c in producer_ops_here] or [1.0])
            g = _traced_compress(
                trace, f"enc grad({a})", f"stage{si}", True, ratio,
                lambda g=g, ratio=ratio: compress_for_edge(g, ratio,
                                                           use_kernel),
                kernel_cb=kernel_cb, stage=si,
                dense_bytes=dense_payload_bytes(g))
            grad_mail[a] = grad_mail[a] + g if a in grad_mail else g
    return grads


def pipeline_loss_and_grad(prog: PipelineProgram, params: Params,
                           inputs: Mapping[str, torch.Tensor],
                           plan: Optional[CompressionPlan] = None,
                           use_kernel: KernelPolicy = False,
                           timing_cb: Optional[TimingCb] = None,
                           trace: Optional[Any] = None,
                           kernel_cb: Optional[KernelCb] = None
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One RAD iteration (all stages, one micro-batch)."""
    loss, vjps, received = pipeline_forward(prog, params, inputs, plan,
                                            use_kernel, timing_cb=timing_cb,
                                            trace=trace, kernel_cb=kernel_cb)
    grads = pipeline_backward(prog, vjps, received, plan, use_kernel,
                              timing_cb=timing_cb, trace=trace,
                              kernel_cb=kernel_cb)
    return loss, grads


def pipeline_train_step(prog: PipelineProgram, params: Params,
                        micro_batches: Sequence[Mapping[str, torch.Tensor]],
                        plan: Optional[CompressionPlan] = None,
                        use_kernel: KernelPolicy = False
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """GPipe-style accumulation over micro-batches (paper Eq. 3 schedule;
    numerically the order does not matter, the executor models the timing)."""
    total_loss = None
    acc: Optional[Dict[str, Any]] = None
    for mb in micro_batches:
        loss, grads = pipeline_loss_and_grad(prog, params, mb, plan, use_kernel)
        total_loss = loss if total_loss is None else total_loss + loss
        acc = grads if acc is None else tree_map(torch.add, acc, grads)
    n = float(len(micro_batches))
    return total_loss / n, tree_map(lambda g: g / n, acc)


def init_ef_state(prog: PipelineProgram, params: Params,
                  inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals, one per backward (gradient) edge —
    keyed by producer op.  Shapes come from a throwaway forward."""
    _, _, received = pipeline_forward(prog, params, inputs)
    shapes: Dict[str, torch.Tensor] = {}
    for ext in received:
        for a, v in ext.items():
            shapes[a] = torch.zeros_like(v)
    return shapes


def pipeline_loss_and_grad_ef(prog: PipelineProgram, params: Params,
                              inputs: Mapping[str, torch.Tensor],
                              plan: CompressionPlan,
                              ef_state: Dict[str, torch.Tensor],
                              use_kernel: KernelPolicy = False,
                              timing_cb: Optional[TimingCb] = None,
                              trace: Optional[Any] = None,
                              kernel_cb: Optional[KernelCb] = None
                              ) -> Tuple[torch.Tensor, Dict[str, Any],
                                         Dict[str, torch.Tensor]]:
    """RAD iteration with error feedback on the BACKWARD (gradient) edges
    (beyond-paper: EF-SGD residual memory).

    Forward activations compress exactly as the paper's transport; the
    gradient of each cross-node edge sends TopK(g + residual) and keeps
    what was dropped for the next step."""
    from .compression import ratio_to_k, topk_mask

    # forward-only transport compression here; the gradient direction is
    # compressed below, WITH the residual memory (compressing it twice
    # would sparsify the cotangent before EF sees it).
    loss, vjps, received = pipeline_forward(prog, params, inputs, plan,
                                            use_kernel, compress_bwd=False,
                                            timing_cb=timing_cb, trace=trace,
                                            kernel_cb=kernel_cb)
    n_stages = len(prog.subdags)
    grad_mail: Dict[str, torch.Tensor] = {}
    grads: Dict[str, Any] = {}
    new_ef = dict(ef_state)

    for si in range(n_stages - 1, -1, -1):
        sd = prog.subdags[si]
        sends_cot = {a: grad_mail[a] for a in sd.send_acti}
        t0 = time.perf_counter() if timing_cb else 0.0
        p_cot, ext_cot = vjps[si]((sends_cot, 1.0))
        if timing_cb:
            _sync((p_cot, ext_cot))
            timing_cb(si, True, time.perf_counter() - t0)
        grads.update(p_cot)
        for a, g in ext_cot.items():
            consumer_ops = [n for n in sd.node_names
                            if a in prog.graph.nodes[n].args]
            ratio = max([plan.ratio(a, c) for c in consumer_ops] or [1.0])
            if ratio > 1.0:
                corrected = g + ef_state[a].to(g.dtype)
                k = ratio_to_k(g.numel(), ratio)
                sent = _traced_compress(
                    trace, f"enc ef({a})", f"stage{si}", True, ratio,
                    lambda corrected=corrected, k=k: topk_mask(
                        corrected, k, use_kernel=use_kernel),
                    kernel_cb=kernel_cb, stage=si,
                    dense_bytes=dense_payload_bytes(g))
                new_ef[a] = corrected - sent
                g = sent
            grad_mail[a] = grad_mail[a] + g if a in grad_mail else g
    return loss, grads, new_ef


def single_device_loss_and_grad(graph: OpGraph, params: Params,
                                inputs: Mapping[str, torch.Tensor]
                                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Reference semantics: whole graph on one device, plain autograd — the
    ground truth RAD must reproduce when compression is off."""
    p_leaf = _leaf_params(dict(params))
    with torch.enable_grad():
        vals = graph.apply(p_leaf, inputs)
        loss = sum(torch.sum(vals[ln]).to(torch.float32)
                   for ln in graph.loss_nodes())
    leaves = [t for t in tree_leaves(p_leaf) if t.requires_grad]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_map(_cotangents(leaves, grads), p_leaf)
