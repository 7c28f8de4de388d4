"""The system under test: the port's training steps, built as its
launcher builds them, driven one step a call.

* ``FusionProgram`` — ``launch/train.train_fusion``'s step: the OP-DAG
  (``gpt_opgraph``) cut by OP-Fence over paper testbed 1, the uniform or
  AdaTopK plan, ``DecentralizedRuntime.train_step`` with the CUDA wire
  codec (``use_kernel="auto"``), then AdamW's update in the gradients'
  memory.
* ``GspmdProgram`` — the one-card baseline: ``make_train_step`` on the
  whole model (autograd, global-norm clip, AdamW).

``fault`` plants a fault in the timed path for the tests of the check
(never in a benchmark run): ``frozen`` returns the state unchanged,
``half_batch`` trains on the first half of the rows, ``dense_wire`` sends
every boundary uncompressed.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

FAULTS = ("frozen", "half_batch", "dense_wire")


def model_cfg(cfg: dict, seq: int):
    """The port's ``ModelCfg`` for a configuration file's entries."""
    from repro_torch.configs.base import ModelCfg
    return ModelCfg(
        name=cfg["name"], family="dense", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        vocab_pad_to=cfg["vocab_pad_to"], norm=cfg["norm"], act=cfg["act"],
        rope_fraction=cfg["rope_fraction"], rope_theta=cfg["rope_theta"],
        max_seq=max(cfg["max_seq"], seq), window=None,
        tie_embeddings=cfg["tie_embeddings"], qkv_bias=cfg["linear_bias"])


def _optimizer(traffic: dict):
    from repro_torch.optim import adamw, linear_warmup_cosine
    return adamw(linear_warmup_cosine(traffic["lr"], traffic["warmup"],
                                      traffic["total_steps"]),
                 b1=traffic["b1"], b2=traffic["b2"], eps=traffic["eps"],
                 weight_decay=traffic["weight_decay"])


class _Program:
    def __init__(self, fault: Optional[str], device: torch.device):
        self.device = device
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        self.spans = {"executor": [], "update": []}

    def _rows(self, tokens, labels):
        if self.fault == "half_batch":
            half = tokens.shape[0] // 2
            return tokens[:half], labels[:half]
        return tokens, labels

    def _timed(self, name: str, traced: bool, fn):
        """``fn()``; with ``traced`` a host span that ends when the device
        has finished it."""
        if not traced:
            return fn()
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.spans[name].append(time.perf_counter() - t0)
        return out


class FusionProgram(_Program):
    def __init__(self, cfg: dict, traffic: dict, params: dict,
                 device: torch.device, fault: Optional[str] = None):
        super().__init__(fault, device)
        from repro_torch.core import (DecentralizedRuntime, network,
                                      plan_adatopk, plan_none, plan_uniform,
                                      schedule_opfence)
        from repro_torch.models.opgraph_models import gpt_opgraph
        B, S = traffic["batch"], traffic["seq"]
        t0 = time.perf_counter()
        graph = gpt_opgraph(model_cfg(cfg, S), B, S)
        prof = graph.annotate({"tokens": (B, S), "labels": (B, S)})
        cluster = network.paper_testbed(traffic["testbed"], seed=0)
        sch = schedule_opfence(graph, prof, cluster)
        ratio, ef = traffic["ratio"], traffic["error_feedback"]
        if fault == "dense_wire":
            plan = plan_none(graph, sch.placement)
        elif traffic["compress"] == "uniform":
            plan = plan_uniform(graph, sch.placement, ratio,
                                error_feedback=ef)
        else:
            plan = plan_adatopk(graph, prof, cluster, sch.placement, ratio,
                                error_feedback=ef)
        self.plan_s = time.perf_counter() - t0
        self.plan = plan
        self.runtime = DecentralizedRuntime(graph, sch, plan,
                                            use_kernel="auto", device=device)
        self.opt = _optimizer(traffic)
        self.params = params
        self.state = self.opt.init(params)

    def step(self, tokens, labels, traced: bool = False) -> torch.Tensor:
        from repro_torch.optim import distinct_storage
        tokens, labels = self._rows(tokens, labels)
        loss, grads = self._timed("executor", traced, lambda: (
            self.runtime.train_step(self.params,
                                    [{"tokens": tokens, "labels": labels}])))
        if self.fault == "frozen":
            return loss
        self.params, self.state = self._timed(
            "update", traced, lambda: self.opt.update(
                distinct_storage(grads), self.state, self.params,
                consume_grads=True))
        return loss

    def first_moment(self):
        return self.state.inner["m"]

    def stages(self):
        """The pipeline's ops a stage, placeholders left out, and the
        compressed edges with their ratios."""
        from repro_torch.core.opgraph import OpType
        graph = self.runtime.graph
        cuts = [[n for n in sd.node_names
                 if graph.nodes[n].op_type is not OpType.PLACEHOLDER]
                for sd in self.runtime.prog.subdags]
        return cuts, dict(self.plan.edge_ratio)


class GspmdProgram(_Program):
    def __init__(self, cfg: dict, traffic: dict, params: dict,
                 device: torch.device, fault: Optional[str] = None):
        super().__init__(fault, device)
        if fault == "dense_wire":
            raise ValueError("the whole-model step has no wire")
        from repro_torch.distributed.steps import make_train_step
        self.plan_s = None
        self.opt = _optimizer(traffic)
        self.step_fn = make_train_step(model_cfg(cfg, traffic["seq"]), self.opt,
                                       grad_clip=traffic["grad_clip"])
        self.params = params
        self.state = self.opt.init(params)

    def step(self, tokens, labels, traced: bool = False) -> torch.Tensor:
        tokens, labels = self._rows(tokens, labels)
        params, state, m = self.step_fn(self.params, self.state,
                                        {"tokens": tokens, "labels": labels})
        if self.fault != "frozen":
            self.params, self.state = params, state
        return m["loss"]

    def first_moment(self):
        return self.state.inner["m"]


def build(cfg: dict, traffic: dict, params: dict, device: torch.device,
          fault: Optional[str] = None):
    cls = {"fusion": FusionProgram, "gspmd": GspmdProgram}[traffic["mode"]]
    return cls(cfg, traffic, params, device, fault)
