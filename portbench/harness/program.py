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
(never in a benchmark run): ``frozen`` leaves the state unchanged,
``half_batch`` trains on the first half of the rows, ``dense_wire`` sends
every boundary uncompressed.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import torch

FAULTS = ("frozen", "half_batch", "dense_wire")


# Keys of a configuration file that reach no ``ModelCfg``: those that
# document it, and those only the reference reads.
DOCUMENTS = ("source", "paper", "published", "reduced", "assumed",
             "deployment")
REFERENCE_ONLY = ("norm_eps",)
DTYPES = {"float32": torch.float32}


def port_families() -> set:
    """The block families of the port's registered configurations: those
    its models build."""
    from repro_torch import configs
    configs.load_all()
    return {entry.full.family for entry in configs.REGISTRY.values()}


def model_cfg(cfg: dict, seq: int):
    """The port's ``ModelCfg`` for a configuration file's entries: every
    key that names one of its fields is passed to it, ``linear_bias`` as
    ``qkv_bias``, ``max_seq`` at least ``seq``; any other key, or a
    ``family`` the port builds none of, raises."""
    from repro_torch.configs.base import ModelCfg
    if cfg["family"] not in port_families():
        raise ValueError(f"family {cfg['family']!r} of {cfg['name']!r} is "
                         f"none of the port's: {sorted(port_families())}")
    fields = {f.name for f in dataclasses.fields(ModelCfg)}
    kw = {}
    for key, value in cfg.items():
        if key in DOCUMENTS or key in REFERENCE_ONLY:
            continue
        if key == "linear_bias":
            kw["qkv_bias"] = value
        elif key == "max_seq":
            kw["max_seq"] = max(value, seq)
        elif key == "dtype":
            kw["dtype"] = DTYPES[value]
        elif key in fields:
            kw[key] = value
        else:
            raise KeyError(f"configuration key {key!r} of {cfg['name']!r} "
                           "is no field of the port's ModelCfg")
    return ModelCfg(**kw)


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
        batch = {"tokens": tokens, "labels": labels}
        if self.fault == "frozen":
            # the step writes AdamW's moments over the state it is given
            params, state = copy.deepcopy((self.params, self.state))
            return self.step_fn(params, state, batch)[2]["loss"]
        self.params, self.state, m = self.step_fn(self.params, self.state,
                                                  batch)
        return m["loss"]

    def first_moment(self):
        return self.state.inner["m"]


def build(cfg: dict, traffic: dict, params: dict, device: torch.device,
          fault: Optional[str] = None):
    cls = {"fusion": FusionProgram, "gspmd": GspmdProgram}[traffic["mode"]]
    return cls(cfg, traffic, params, device, fault)
