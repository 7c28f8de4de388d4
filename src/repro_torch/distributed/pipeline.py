"""FusionLLM pipeline on a mesh: GPipe, AdaTopK on the pod-crossing edge,
RAD.

The paper's runtime — inter-layer stages, boundary activations and
gradients on links, Top-K compression on the *slowest* links — as one
program that drives every stage (a single controller), as the JAX
package's ``shard_map`` program does:

* stage axis = the mesh's ``model`` axis (single pod) or the flattened
  ``pod × model`` axes (multi-pod); stage s runs on the device at its mesh
  position, so exactly the stage boundaries that cross a pod boundary ride
  the slow links;
* boundary transfer = ``.to(device of stage s + 1)`` (JAX: ``ppermute``);
* AdaTopK = :func:`repro_torch.core.compression.boundary_compress` on the
  outgoing boundary of a slow edge, with the per-edge ratio of Eq. 7
  (:func:`pod_edge_ratios`): pod-crossing edges get ``3r``, intra-pod edges
  ratio 1 (no compression);
* schedule = GPipe (paper Eq. 3): ``n_micro + n_stages - 1`` ticks, stage s
  processes micro-batch ``t - s`` at tick t;
* RAD = autograd through the schedule: each stage's backward runs where its
  forward ran, and boundary gradients come back over the hand-off and
  through the compressed backward (``boundary_compress`` sparsifies the
  cotangent with the same k).

Where it differs from the JAX program, the loss and gradients do not:

* only the active (stage, micro-batch) pairs run, ``n_micro × n_stages``
  calls in tick order.  SPMD makes JAX compute every stage at every tick;
  an inactive tick feeds only inactive ticks and is masked out of the loss;
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

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.compression import boundary_compress, ratio_to_k
from repro_torch.core.rad import tree_map
from repro_torch.models import causal_lm
from repro_torch.models.layers import cross_entropy, norm_apply
from repro_torch.models.scan_config import unstack
from .sharding import Mesh
from .steps import value_and_grad


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


def make_pipeline_train_fn(cfg: ModelCfg, mesh: Mesh, n_micro: int,
                           base_ratio: float = 1.0,
                           use_kernel=False) -> Callable:
    """Returns ``loss_fn(params, batch)`` running the GPipe schedule over
    the mesh's stages.  batch tokens: (n_micro, mb, S).  ``use_kernel`` is
    the codec's dispatch policy (``compression.topk_mask``): ``False`` a
    global Top-K, ``"auto"`` the blockwise wire codec (the CUDA kernels for
    a CUDA tensor)."""
    if cfg.family not in ("dense",):
        raise NotImplementedError("pipeline path covers the dense family "
                                  "(the paper's GPT-2 workload)")
    ns = n_stages(mesh)
    ratios = pod_edge_ratios(mesh, base_ratio)
    devs = stage_devices(mesh)
    head_keys = ("final_norm", "embed" if cfg.tie_embeddings else "head")

    def run_stage(layers, x):
        for pl in layers:
            x = causal_lm._dense_block(cfg, pl, x, cfg.window)
        return x

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
                y = run_stage(stages[s], x)
                if s == ns - 1:
                    h = norm_apply(cfg.norm, last["final_norm"], y)
                    loss = loss + cross_entropy(
                        causal_lm._head(cfg, last, h), labels[m])
                    continue
                if ratios[s] > 1.0:             # Eq. 7: a slow edge
                    k = ratio_to_k(y.numel(), float(ratios[s]))
                    y = boundary_compress(y, k, k, use_kernel)
                inbox[(s + 1, m)] = y.to(devs[s + 1])
        return loss / n_micro

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
