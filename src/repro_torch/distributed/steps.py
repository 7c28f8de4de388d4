"""Step builders and abstract input specs of the gspmd path.

The JAX package jits these steps with explicit shardings over the mesh; on
one card the train step is plain autograd (``train_loss`` -> gradients ->
``clip_by_global_norm`` -> ``optimizer.update``); the prefill and decode
steps call the model's ``prefill`` / ``decode_step`` eagerly: ``encdec``'s
for the encoder-decoder, ``causal_lm``'s for every other family (the
hybrid and xLSTM included: they are served this way, never
stage-sharded).  On a process mesh the same steps run on DTensors placed by
those shardings, for every family.

The abstract inputs (:func:`input_specs`, :func:`decode_state_specs`,
:func:`abstract_params`) are tensors on the ``meta`` device, in the JAX
package's trees.  :func:`cache_shardings` and :func:`batch_shardings` give
the JAX package's specs over a :class:`~repro_torch.distributed.sharding.Mesh`;
:func:`build_jitted` assembles a step, its abstract arguments and the
parameters' shardings as the JAX package's does, and runs on one device or
sharded over a process mesh.

Step kinds per input shape:
* train_4k    -> ``train_step(params, opt_state, batch)``
* prefill_32k -> ``prefill_step(params, batch)``
* decode_32k / long_500k -> ``serve_step(params, cache, tokens)`` — one new
  token against a seq_len-deep cache.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelCfg
from repro_torch.core.opgraph import tree_leaves
from repro_torch.core.rad import tree_map
from repro_torch.models import causal_lm, encdec
from repro_torch.optim import (Optimizer, clip_by_global_norm,
                               distinct_storage)
from .params import (batch_spec, generic_spec, param_shardings, place_tree,
                     tree_map_with_path, tree_path_str)
from .sharding import (Mesh, NamedSharding, PartitionSpec as P, is_dtensor,
                       replicate_like)


# ============================================================ input specs ==
def src_len_for(cfg: ModelCfg, seq_len: int) -> int:
    """Audio source frames for enc-dec shapes (8 tokens/frame heuristic)."""
    return max(seq_len // 8, 16)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Abstract batch (``meta`` tensors) for train/prefill shapes (decode
    builds caches too — see :func:`decode_state_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        spec = {"src_embeds": _spec((B, src_len_for(cfg, S),
                                     cfg.d_frontend), cfg.dtype),
                "tokens": _spec((B, S), i32)}
        if shape.kind == "train":
            spec["labels"] = _spec((B, S), i32)
        return spec
    S_text = S - cfg.n_prefix if cfg.n_prefix else S
    spec = {"tokens": _spec((B, S_text), i32)}
    if shape.kind == "train":
        spec["labels"] = _spec((B, S_text), i32)
    if cfg.n_prefix:
        spec["prefix_embeds"] = _spec((B, cfg.n_prefix, cfg.d_frontend),
                                      cfg.dtype)
    return spec


def decode_window(cfg: ModelCfg, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k":
        return cfg.long_window or cfg.window
    return cfg.window


def decode_state_specs(cfg: ModelCfg, shape: InputShape) -> Any:
    """Abstract decode cache (``meta`` tensors) for the serve step."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return encdec.cache_init(cfg, B, S, src_len_for(cfg, S),
                                 device="meta")
    return causal_lm.cache_init(cfg, B, S, device="meta")


# ======================================================== cache shardings ==
def cache_shardings(cache_shapes: Any, mesh: Mesh, global_batch: int) -> Any:
    """Path-aware sharding for decode caches.

    KV caches shard batch + head_dim over model; SSM/xLSTM states shard
    batch + the widest feature dim over model.  Anything indivisible
    replicates — correctness never depends on these choices.
    """
    bspec = batch_spec(global_batch, mesh)
    baxes = bspec[0] if len(bspec) and bspec[0] is not None else None
    msz = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def shard_dim(spec, shape, idx, axis, size):
        if size > 1 and shape[idx] % size == 0 and shape[idx] >= size:
            spec[idx] = axis

    def rule(path, leaf):
        pstr = tree_path_str(path)
        name = pstr.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        in_slstm = "/s/" in pstr or pstr.endswith("/s")

        def setb(idx):
            if baxes is not None and nd >= -idx and shape[idx] == global_batch:
                spec[idx] = baxes

        if name == "pos" or nd == 0:
            return NamedSharding(mesh, P())
        if name in ("k", "v", "xk", "xv"):
            # not the sequence dim, which decode writes at a traced position
            setb(-4)
            shard_dim(spec, shape, -1, "model", msz)      # head_dim
        elif name == "h" and not in_slstm:                # mamba state
            setb(-4)
            shard_dim(spec, shape, -3, "model", msz)      # ssm heads
        elif name == "conv":
            setb(-3)
            shard_dim(spec, shape, -1, "model", msz)      # channels
        elif name == "C":                                  # mLSTM matrix mem
            setb(-4)
            shard_dim(spec, shape, -1, "model", msz)
        elif name in ("n", "c", "h", "m"):                 # vector states
            setb(-3)
            shard_dim(spec, shape, -1, "model", msz)
        return NamedSharding(mesh, P(*spec))

    return tree_map_with_path(rule, cache_shapes)


def batch_shardings(batch_shapes: Dict[str, torch.Tensor], mesh: Mesh,
                    global_batch: int) -> Dict[str, Any]:
    bspec = batch_spec(global_batch, mesh)

    def rule(_, leaf):
        spec = list(bspec) + [None] * (leaf.dim() - len(bspec))
        return NamedSharding(mesh, P(*spec[:leaf.dim()]))

    return tree_map_with_path(rule, batch_shapes)


# ================================================================== steps ==
def value_and_grad(fn: Callable, params, has_aux: bool = False):
    """``jax.value_and_grad`` by autograd: ``(fn(params), grads)``, or with
    ``has_aux`` ``((loss, aux), grads)`` for an ``fn`` returning (loss,
    aux); grads has params' key paths, and nothing returned holds the
    graph.  A DTensor parameter's gradient is reduced to the parameter's
    placements (autograd leaves it where the backward put it, often
    ``Partial``), as JAX's gradients carry the parameters' shardings."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = fn(leaves)
    loss = out[0] if has_aux else out
    flat = tree_leaves(leaves)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    grads = tree_map(lambda p: _placed_like(grads[id(p)], p), leaves)
    if has_aux:
        return (loss.detach(), tree_map(lambda v: v.detach(), out[1])), grads
    return loss.detach(), grads


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if not is_dtensor(p) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def loss_and_grad(cfg: ModelCfg, params, batch):
    """(loss, metrics, grads) of the model's ``train_loss`` at ``params``;
    grads has params' key paths."""
    model = encdec if cfg.family == "encdec" else causal_lm
    (loss, metrics), grads = value_and_grad(
        lambda p: model.train_loss(cfg, p, batch), params, has_aux=True)
    return loss, metrics, grads


def make_train_step(cfg: ModelCfg, optimizer: Optimizer,
                    grad_clip: float = 1.0) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "ce", "aux"})``.  The step owns the gradients
    it makes and gives up the optimizer state it is passed, as the JAX
    package's jitted step donates ``params`` and ``opt_state``: it clips
    the gradients where they are and lets the optimizer compute in their
    memory (``Optimizer.update(..., consume_grads=True)``; AdamW writes its
    new moments over the old ones), so it holds two parameter-sized trees
    beside the optimizer's state, not three; the numbers are the
    functional formula's."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grad(cfg, params, batch)
        grads = distinct_storage(grads)
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = replicate_like(torch.zeros((), dtype=torch.float32,
                                               device=loss.device), loss)
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             consume_grads=True)
        out_metrics = {"loss": loss, "grad_norm": gnorm}
        out_metrics.update(metrics)
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelCfg, cache_len: int,
                      window: Optional[int] = None) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits, cache)``."""
    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return encdec.prefill(cfg, params, batch["src_embeds"],
                                  batch["tokens"], cache_len)
    else:
        def prefill_step(params, batch):
            return causal_lm.prefill(cfg, params, batch["tokens"],
                                     cache_len=cache_len,
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     window=window)
    return prefill_step


def make_decode_step(cfg: ModelCfg, window: Optional[int] = None) -> Callable:
    """``serve_step(params, cache, tokens) -> (logits, new cache)``: one new
    token against the cache, which is left as it was."""
    if cfg.family == "encdec":
        def serve_step(params, cache, tokens):
            return encdec.decode_step(cfg, params, cache, tokens)
    else:
        def serve_step(params, cache, tokens):
            return causal_lm.decode_step(cfg, params, cache, tokens,
                                         window=window)
    return serve_step


# ============================================================== assembler ==
def abstract_params(cfg: ModelCfg) -> Any:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, nothing
    allocated (a CPU generator, drawing nowhere)."""
    mod = encdec if cfg.family == "encdec" else causal_lm
    return mod.init(cfg, torch.Generator().manual_seed(0), device="meta")


def _abstract(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _placed_step(step: Callable, in_sh: tuple, out_sh: tuple) -> Callable:
    """``step`` with ``jax.jit``'s placement of its arguments
    (``in_shardings``) and results (``out_shardings``; ``None`` leaves a
    result where the step put it) on a process mesh."""
    def placed(*args):
        out = step(*(place_tree(a, sh) for a, sh in zip(args, in_sh)))
        return tuple(r if sh is None else place_tree(r, sh)
                     for r, sh in zip(out, out_sh))
    return placed


def build_jitted(cfg: ModelCfg, mesh: Mesh, shape: InputShape,
                 optimizer: Optional[Optimizer] = None,
                 param_overrides: Optional[Dict[str, P]] = None,
                 remat: bool = False):
    """Assemble the step + abstract example args for one (arch ×
    input-shape × mesh).  Returns ``(fn, args, meta)`` as the JAX package's
    does: ``args`` are ``meta`` tensors (params, then the optimizer state and
    batch of a train step, the batch of a prefill, or the cache and tokens
    of a decode step); ``meta["param_sh"]`` holds the parameters'
    shardings, ``meta["in_shardings"]`` those of every argument, as the JAX
    package jits the step with them (and ``meta["cache_sh"]`` those of the
    cache a prefill returns).

    ``fn`` is the eager step.  Nothing is jitted: PyTorch runs the step as
    written, with no trace to compile against the shardings.  The prefill
    and decode steps return new tensors and write none of their inputs.
    The train step writes its new parameters into the memory of the
    gradients it made and, on plain tensors, AdamW's new moments over
    those of the state it was passed (:func:`make_train_step`), as JAX's
    donates ``params`` and ``opt_state``, so it holds two parameter-sized
    trees beside the optimizer's state, not three.  ``remat`` changes
    nothing, as in
    JAX (the model checkpoints its blocks by ``cfg.remat``).

    On a process mesh (``launch.mesh.make_process_mesh``) every step takes
    and returns DTensors: its arguments are redistributed to
    ``meta["in_shardings"]``, and its results to the shardings JAX's
    ``out_shardings`` names (the train step's new parameters and optimizer
    state; the cache a prefill or decode step returns, on
    ``meta["cache_sh"]``; the logits and metrics stay where the step left
    them); a plain tensor among the arguments raises.  Run it under
    ``use_mesh(mesh)`` for the model's ``constrain`` calls, as the JAX
    package's callers do.  Every family and every MoE dispatch runs
    there.  A mesh of devices in
    one process whose positions hold several distinct devices raises
    ``NotImplementedError``: placing shards across them needs the process
    mesh."""
    del remat
    if not mesh.is_process_mesh and len(mesh.distinct_devices()) > 1:
        raise NotImplementedError(
            f"build_jitted on {mesh!r}: the port runs a step on one device "
            f"and places no shards across several")
    from repro_torch.optim import adafactor
    optimizer = optimizer or adafactor(1e-3)
    p_abs = abstract_params(cfg)
    p_sh = param_shardings(p_abs, mesh, overrides=param_overrides)
    B = shape.global_batch

    if shape.kind == "train":
        opt_abs = tree_map_with_path(lambda _, t: _abstract(t),
                                     optimizer.init(p_abs))
        opt_sh = tree_map_with_path(
            lambda _, t: NamedSharding(mesh, generic_spec(tuple(t.shape),
                                                          mesh)), opt_abs)
        batch_abs = input_specs(cfg, shape)
        b_sh = batch_shardings(batch_abs, mesh, B)
        step = make_train_step(cfg, optimizer)
        if mesh.is_process_mesh:
            step = _placed_step(step, (p_sh, opt_sh, b_sh),
                                (p_sh, opt_sh, None))
        return (step, (p_abs, opt_abs, batch_abs),
                {"param_sh": p_sh, "in_shardings": (p_sh, opt_sh, b_sh)})

    if shape.kind == "prefill":
        batch_abs = input_specs(cfg, shape)
        b_sh = batch_shardings(batch_abs, mesh, B)
        c_sh = cache_shardings(decode_state_specs(cfg, shape), mesh, B)
        fn = make_prefill_step(cfg, cache_len=shape.seq_len,
                               window=cfg.window)
        if mesh.is_process_mesh:
            fn = _placed_step(fn, (p_sh, b_sh), (None, c_sh))
        return fn, (p_abs, batch_abs), {"param_sh": p_sh,
                                        "in_shardings": (p_sh, b_sh),
                                        "cache_sh": c_sh}

    # decode
    cache_abs = decode_state_specs(cfg, shape)
    c_sh = cache_shardings(cache_abs, mesh, B)
    tok_abs = _spec((B, 1), torch.int32)
    t_sh = batch_shardings({"t": tok_abs}, mesh, B)["t"]
    fn = make_decode_step(cfg, window=decode_window(cfg, shape))
    if mesh.is_process_mesh:
        fn = _placed_step(fn, (p_sh, c_sh, t_sh), (None, c_sh))
    return fn, (p_abs, cache_abs, tok_abs), {"param_sh": p_sh,
                                             "in_shardings": (p_sh, c_sh,
                                                              t_sh),
                                             "cache_sh": c_sh}
