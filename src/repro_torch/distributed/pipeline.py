"""FusionLLM pipeline on a mesh: GPipe, AdaTopK on the pod-crossing edge,
RAD.

The paper's runtime — inter-layer stages, boundary activations and
gradients on links, Top-K compression on the *slowest* links — as the JAX
package's ``shard_map`` program runs it:

* stage axis = the mesh's ``model`` axis (single pod) or the flattened
  ``pod × model`` axes (multi-pod), so exactly the stage boundaries that
  cross a pod boundary ride the slow links;
* AdaTopK = top-k on the outgoing boundary of a slow edge, with the
  per-edge ratio of Eq. 7 (:func:`pod_edge_ratios`): pod-crossing edges get
  ``3r``, intra-pod edges ratio 1 (no compression);
* schedule = GPipe (paper Eq. 3): ``n_micro + n_stages - 1`` ticks, stage s
  processes micro-batch ``t - s`` at tick t;
* RAD = autograd through the schedule: each stage's backward runs where its
  forward ran, and a slow edge's boundary gradient comes back sparsified
  with the same k.

It runs two ways, by the mesh:

* **A mesh of devices in one process** (``launch.mesh.make_mesh``): one
  program drives every stage (a single controller).  Stage s runs on the
  device at its mesh position, the boundary is handed on with ``.to(device
  of stage s + 1)``, and a slow edge applies
  :func:`repro_torch.core.compression.boundary_compress` (the codec's
  encode and decode back to back on the sender's device).
* **A process mesh** (``launch.mesh.make_process_mesh``): each rank runs
  its stage, as each device runs its part of JAX's program, and the
  boundary goes from rank to rank by ``send`` / ``recv`` (JAX:
  ``ppermute``).  The parameters are DTensors placed by
  :func:`pipeline_shardings`, as JAX's ``in_specs`` place them: each block
  leaf split on its layer dimension over the stage axes, every other leaf
  replicated.  What crosses a slow edge is the wire: the sender encodes
  (``kernels.ops.codec_encode``: k values and a bitmap a block, sent as one
  message), the receiver decodes, and trains on exactly
  ``boundary_compress``'s tensor.  The backward runs back over the same
  edges: the receiver encodes the gradient of its input with the same k,
  and the sender decodes it and goes on from its output, which is
  ``boundary_compress``'s backward.  The global Top-K (``use_kernel=False``)
  has no wire: its masked tensor crosses dense, as does every intra-pod
  boundary.  Every rank returns the same loss (the last stage's), and the
  gradients of the replicated leaves are summed over the stages, as JAX's
  transpose of their ``P()`` in_specs sums them, so every copy takes the
  same update.  Ranks that differ on another axis (a replica axis such as
  ``data``) run the same pipeline on the same batch and hold the single
  pipeline's gradients.

Where it differs from the JAX program, the loss and gradients do not:

* only the active (stage, micro-batch) pairs run, ``n_micro × n_stages``
  calls in tick order.  SPMD makes JAX compute every stage at every tick;
  an inactive tick feeds only inactive ticks and is masked out of the loss;
* on a process mesh the wire is what crosses a slow edge; JAX's program
  compresses on the sender and permutes the dense result;
* there is no ``jax.checkpoint`` around the program: JAX needs it to
  differentiate ``shard_map`` on its pinned version.

One difference changes the loss: the head masks the padded vocabulary, as
the model's own forward does (``causal_lm._head``), so the uncompressed
pipeline equals ``train_loss``.  The JAX pipeline's head leaves the padded
classes in its softmax; the two agree when ``vocab_padded == vocab`` (every
smoke config) and differ at gpt2-xl's full size (50,257 padded to 50,432).

Supports the dense family (the paper's GPT-2 workload).  n_layers must
divide evenly into stages.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.compression import (boundary_compress, ratio_to_k,
                                          topk_mask)
from repro_torch.core.opgraph import tree_leaves
from repro_torch.core.rad import tree_map
from repro_torch.kernels import ops
from repro_torch.models import causal_lm
from repro_torch.models.layers import cross_entropy, norm_apply
from repro_torch.models.scan_config import unstack
from .sharding import Mesh, NamedSharding, PartitionSpec as P
from .steps import abstract_params, value_and_grad


def stage_axes(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "model") if "pod" in mesh.axis_names else ("model",)


def n_stages(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in stage_axes(mesh)]))


def stage_devices(mesh: Mesh) -> List[torch.device]:
    """Device of each stage: the mesh position at the stage's coordinates
    on the stage axes and 0 on every other axis (JAX's other axes hold
    replicas of the same pipeline)."""
    if mesh.devices is None:
        raise ValueError(f"the pipeline needs a mesh with devices: {mesh!r}")
    axes = stage_axes(mesh)
    out = []
    for s in range(n_stages(mesh)):
        coord = dict(zip(axes, np.unravel_index(
            s, [mesh.shape[a] for a in axes])))
        out.append(mesh.devices[tuple(int(coord.get(a, 0))
                                      for a in mesh.axis_names)])
    return out


def pod_edge_ratios(mesh: Mesh, base_ratio: float,
                    index_overhead: float = 3.0) -> np.ndarray:
    """Per-boundary compression ratio (edge s -> s+1), Eq. 7.

    R_i for an intra-pod edge vs a pod-crossing edge differs by ~the
    bandwidth gap; with only two tiers, Eq. 7 degenerates to: slowest edges
    get ``3r``, fast edges get 1 (max(1, 3r·R_i/R_max) with R_i ≪ R_max).
    """
    ns = n_stages(mesh)
    ratios = np.ones(ns)            # edge i: stage i -> i+1 (cyclic unused)
    if "pod" in mesh.axis_names:
        per_pod = mesh.shape["model"]
        for s in range(ns - 1):
            if (s + 1) % per_pod == 0:           # crossing into next pod
                ratios[s] = max(1.0, index_overhead * base_ratio)
    return ratios


def _split_stage_params(cfg: ModelCfg, params: Dict[str, Any], ns: int):
    """Reshape stacked block params (L, ...) -> (ns, L/ns, ...); embed/head
    apart (stage 0 / last stage use them)."""
    L = cfg.n_layers
    if L % ns:
        raise ValueError(f"{L} layers not divisible into {ns} stages")
    blocks = tree_map(lambda a: a.reshape((ns, L // ns) + tuple(a.shape[1:])),
                      params["blocks"])
    rest = {k: v for k, v in params.items() if k != "blocks"}
    return blocks, rest


def _on(tree, dev: torch.device):
    return tree_map(lambda a: a.to(dev), tree)


def pipeline_shardings(cfg: ModelCfg, mesh: Mesh) -> Dict[str, Any]:
    """The parameters' shardings on ``mesh`` as JAX's pipeline places them
    (its ``in_specs``): each block leaf split on its layer dimension over
    the stage axes, so the rank at stage s holds that stage's ``L / ns``
    layers, and every other leaf replicated.  ``shard_tree`` or
    ``checkpoint.from_numpy_tree`` places a whole tree by them."""
    ns = n_stages(mesh)
    if cfg.n_layers % ns:
        raise ValueError(f"{cfg.n_layers} layers not divisible into {ns} "
                         f"stages")
    split = NamedSharding(mesh, P(stage_axes(mesh)))
    whole = NamedSharding(mesh, P())

    def placed(key, tree):
        sh = split if key == "blocks" else whole
        return tree_map(lambda _: sh, tree)
    return {k: placed(k, v) for k, v in abstract_params(cfg).items()}


def make_pipeline_train_fn(cfg: ModelCfg, mesh: Mesh, n_micro: int,
                           base_ratio: float = 1.0,
                           use_kernel=False) -> Callable:
    """Returns ``loss_fn(params, batch)`` running the GPipe schedule over
    the mesh's stages.  batch tokens: (n_micro, mb, S).  ``use_kernel`` is
    the codec's dispatch policy (``compression.topk_mask``): ``False`` a
    global Top-K, ``"auto"`` the blockwise wire codec (the CUDA kernels for
    a CUDA tensor).  On a process mesh ``params`` is this rank's part, as
    :func:`pipeline_shardings` places it, and ``batch`` the whole batch on
    every rank, plain tensors."""
    if cfg.family not in ("dense",):
        raise NotImplementedError("pipeline path covers the dense family "
                                  "(the paper's GPT-2 workload)")
    ratios = pod_edge_ratios(mesh, base_ratio)
    if mesh.is_process_mesh:
        return _stage_loss_fn(cfg, mesh, n_micro, ratios, use_kernel)
    ns = n_stages(mesh)
    devs = stage_devices(mesh)
    head_keys = ("final_norm", "embed" if cfg.tie_embeddings else "head")

    def loss_fn(params, batch):
        blocks, rest = _split_stage_params(cfg, params, ns)
        stages = [unstack(_on(b, d)) for b, d in zip(unstack(blocks), devs)]
        first = _on({k: v for k, v in rest.items()
                     if k in ("embed", "pos_embed")}, devs[0])
        last = _on({k: rest[k] for k in head_keys}, devs[-1])
        tokens = batch["tokens"].to(devs[0])
        labels = batch["labels"].to(devs[-1])
        inbox: Dict[Tuple[int, int], torch.Tensor] = {}
        loss = torch.zeros((), dtype=torch.float32, device=devs[-1])
        for t in range(n_micro + ns - 1):
            for s in range(ns):
                m = t - s
                if not 0 <= m < n_micro:
                    continue                    # an inactive tick
                x = (causal_lm._embed_tokens(cfg, first, tokens[m], None)
                     if s == 0 else inbox.pop((s, m)))
                y = _run_stage(cfg, stages[s], x)
                if s == ns - 1:
                    loss = loss + _head_loss(cfg, last, y, labels[m])
                    continue
                if ratios[s] > 1.0:             # Eq. 7: a slow edge
                    k = ratio_to_k(y.numel(), float(ratios[s]))
                    y = boundary_compress(y, k, k, use_kernel)
                inbox[(s + 1, m)] = y.to(devs[s + 1])
        return loss / n_micro

    return loss_fn


def _run_stage(cfg: ModelCfg, layers, x):
    for pl in layers:
        x = causal_lm._dense_block(cfg, pl, x, cfg.window)
    return x


def _head_loss(cfg: ModelCfg, last, y, labels):
    h = norm_apply(cfg.norm, last["final_norm"], y)
    return cross_entropy(causal_lm._head(cfg, last, h), labels)


# ====================================================== on a process mesh ==
FWD, BWD = 0, 1         # a message's way, in its tag: 2 × micro-batch + way


class _Wire:
    """What an edge carries for one micro-batch, either way: the dense
    boundary (an intra-pod edge), the dense Top-K mask (the global policy,
    which has no wire format) or the codec's wire, the bitmap and the
    values packed into one message of bytes.  Both ends size it from k
    and the boundary's static shape."""

    def __init__(self, shape, dtype, device, ratio: float, use_kernel):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.policy = use_kernel
        n = math.prod(self.shape)
        self.k = ratio_to_k(n, ratio)
        self.mode = (ops.resolve_policy(use_kernel, device) if ratio > 1.0
                     else None)
        if self.mode in (None, "global"):
            self.message = (self.shape, dtype)
            return
        self.values, self.bitmap = ops.codec_wire_shapes(n, self.k)
        self.split = torch.empty(self.bitmap, dtype=torch.int32,
                                 device="meta").nbytes
        size = self.split + torch.empty(self.values, dtype=dtype,
                                        device="meta").nbytes
        self.message = ((size,), torch.uint8)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return x
        if self.mode == "global":
            return topk_mask(x, self.k, use_kernel=self.policy)
        values, bitmap = ops.codec_encode(x, self.k, self.mode)
        # the bitmap first: the values then start 4-byte aligned
        return torch.cat([bitmap.reshape(-1).view(torch.uint8),
                          values.reshape(-1).view(torch.uint8)])

    def decode(self, message: torch.Tensor) -> torch.Tensor:
        if self.mode in (None, "global"):
            return message
        bitmap = message[:self.split].view(torch.int32).reshape(self.bitmap)
        values = message[self.split:].view(self.dtype).reshape(self.values)
        return ops.codec_decode(values, bitmap, self.shape, self.mode)


class _Edge:
    """One edge of the pipeline as one of its two ranks sees it: the wire
    and the rank at its other end."""

    def __init__(self, wire: _Wire, peer: int):
        self.wire, self.peer = wire, peer

    def send(self, x: torch.Tensor, m: int, way: int) -> None:
        import torch.distributed as dist
        dist.send(self.wire.encode(x).contiguous(), self.peer,
                  tag=2 * m + way)

    def recv(self, m: int, way: int) -> torch.Tensor:
        import torch.distributed as dist
        shape, dtype = self.wire.message
        message = torch.empty(shape, dtype=dtype, device=self.wire.device)
        dist.recv(message, self.peer, tag=2 * m + way)
        return self.wire.decode(message)


# Each rank threads one zero scalar, the token, through its sends and
# receives in forward order.  The backward of each then waits on the next
# one's, so a rank's backward visits them in exactly the reverse order
# (micro-batch n - 1 first) and its neighbours send and receive in the same
# order it does.
class _Send(torch.autograd.Function):
    """Forward: ``y`` to the next stage.  Backward: its gradient from
    there."""

    @staticmethod
    def forward(ctx, y, token, edge: _Edge, m: int):
        ctx.edge, ctx.m = edge, m
        edge.send(y, m, FWD)
        return token.new_zeros(())

    @staticmethod
    def backward(ctx, g_token):
        return ctx.edge.recv(ctx.m, BWD), g_token, None, None


class _Recv(torch.autograd.Function):
    """Forward: the input from the previous stage.  Backward: its gradient
    back there."""

    @staticmethod
    def forward(ctx, token, edge: _Edge, m: int):
        ctx.edge, ctx.m = edge, m
        return edge.recv(m, FWD), token.new_zeros(())

    @staticmethod
    def backward(ctx, g_x, g_token):
        ctx.edge.send(g_x, ctx.m, BWD)
        return g_token, None, None


class _Tie(torch.autograd.Function):
    """A zero scalar that depends on ``tensors``: it puts them in the
    graph of a loss whose value it leaves alone, with a zero gradient."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return torch.zeros((), device=tensors[0].device)

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                     for shape, dtype, dev in ctx.like)


def _rank_at(mesh: Mesh, coord: Dict[str, int], stage: int) -> int:
    """The rank at ``coord`` with its stage axes moved to ``stage``."""
    axes = stage_axes(mesh)
    at = dict(coord)
    at.update(zip(axes, np.unravel_index(stage, [mesh.shape[a]
                                                 for a in axes])))
    return int(np.ravel_multi_index([at[a] for a in mesh.axis_names],
                                    tuple(mesh.shape.values())))


def _stage_loss_fn(cfg: ModelCfg, mesh: Mesh, n_micro: int,
                   ratios: np.ndarray, use_kernel) -> Callable:
    """``loss_fn(params, batch)`` of this rank's stage on a process mesh
    (the module's docstring)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate

    axes = stage_axes(mesh)
    ns = n_stages(mesh)
    coord = mesh.coordinate()
    s = int(np.ravel_multi_index([coord[a] for a in axes],
                                 [mesh.shape[a] for a in axes]))
    dev = mesh.devices.flat[0]
    # a replicated leaf's local gradient is this stage's share of the sum
    # over the stages, and the same on every rank of another axis
    summed = [Partial() if a in axes else Replicate()
              for a in mesh.axis_names]
    used = set()
    if s == 0:
        used |= {"embed", "pos_embed"}
    if s == ns - 1:
        used |= {"final_norm", "embed" if cfg.tie_embeddings else "head"}
    last_rank = _rank_at(mesh, coord, ns - 1)

    def edge(to: int, ratio: float, shape) -> _Edge:
        return _Edge(_Wire(shape, cfg.dtype, dev, ratio, use_kernel),
                     _rank_at(mesh, coord, to))

    def loss_fn(params, batch):
        blocks = tree_map(lambda p: p.to_local(), params["blocks"])
        rest = {k: tree_map(lambda p: p.to_local(grad_placements=summed), v)
                for k, v in params.items() if k != "blocks"}
        tokens, labels = batch["tokens"].to(dev), batch["labels"].to(dev)
        shape = (tokens.shape[1], tokens.shape[2], cfg.d_model)
        prev = edge(s - 1, float(ratios[s - 1]), shape) if s > 0 else None
        nxt = edge(s + 1, float(ratios[s]), shape) if s < ns - 1 else None
        # the leaves this stage does not read join the graph through the
        # token, so that every rank sums every replicated leaf's gradient
        idle = [t for k, v in rest.items() if k not in used
                for t in tree_leaves(v)]
        token = _Tie.apply(min(tree_leaves(blocks), key=torch.numel), *idle)
        layers = unstack(blocks)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(n_micro):
            if s == 0:
                x = causal_lm._embed_tokens(cfg, rest, tokens[m], None)
            else:
                x, token = _Recv.apply(token, prev, m)
            y = _run_stage(cfg, layers, x)
            if s == ns - 1:
                loss = loss + _head_loss(cfg, rest, y, labels[m])
            else:
                token = _Send.apply(y, token, nxt, m)
        loss = loss / n_micro
        # every rank takes the last stage's value (x + 0 is exact)
        slots = torch.zeros(mesh.size, dtype=torch.float32, device=dev)
        if s == ns - 1:
            slots[dist.get_rank()] = loss.detach()
        dist.all_reduce(slots)
        if s < ns - 1:
            loss = slots[last_rank]
        return loss + token

    return loss_fn


def make_pipeline_train_step(cfg: ModelCfg, mesh: Mesh, optimizer,
                             n_micro: int, base_ratio: float = 1.0):
    loss_fn = make_pipeline_train_fn(cfg, mesh, n_micro, base_ratio)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch), params)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return step


def microbatch(batch: Dict[str, torch.Tensor], n_micro: int
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
        out[k] = v.reshape((n_micro, B // n_micro) + tuple(v.shape[1:]))
    return out
