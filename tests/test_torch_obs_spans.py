"""The training path's profiler spans (``repro_torch.obs.trace.span``), at
smoke size on the CPU.

* With no profiler recording, a span builds nothing: the fusion step, an
  AdamW update and the whole-model step run with ``record_function``
  made to raise.
* Under ``torch.profiler``, each call emits its spans the expected number
  of times (``rad.step`` once, a forward and a backward span a stage, a
  ``rad.wire`` span a boundary edge and direction, ``attn`` a block,
  ``optim.update`` once), and the ``rad.*`` spans nest in ``rad.step``.
* The numbers are the same, bit for bit, with the profiler on and off.
* ``TraceRecorder.region`` records its ring event and, under a profiler,
  a range of its name.
"""
from collections import Counter

import pytest
import torch

from repro_torch.configs import resolve
from repro_torch.core import (DecentralizedRuntime, network, plan_uniform,
                              schedule_opfence)
from repro_torch.core.opgraph import tree_leaves
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import causal_lm
from repro_torch.models.opgraph_models import gpt_opgraph
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw

B, S = 2, 16
CFG = resolve("gpt2-xl").smoke


def _batch(seed=0):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, CFG.vocab, (B, S + 1), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}


def _fusion(error_feedback):
    """A fusion runtime over paper testbed 1 with every boundary edge
    compressed, and its parameters."""
    shapes = {"tokens": (B, S), "labels": (B, S)}
    graph = gpt_opgraph(CFG, B, S)
    prof = graph.annotate(shapes)
    sch = schedule_opfence(graph, prof, network.paper_testbed(1, seed=0))
    plan = plan_uniform(graph, sch.placement, 10.0,
                        error_feedback=error_feedback)
    rt = DecentralizedRuntime(graph, sch, plan, use_kernel="auto",
                              device="cpu")
    params = graph.init(torch.Generator().manual_seed(0), shapes)
    return rt, params


def _names(prof):
    return Counter(e.name for e in prof.events())


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture
def no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was built")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_span_is_the_null_region_without_a_profiler():
    assert obs_trace.span("rad.step") is obs_trace._NULL_REGION
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert obs_trace.span("rad.step") is not obs_trace._NULL_REGION
    assert obs_trace.span("rad.step") is obs_trace._NULL_REGION


@pytest.mark.parametrize("error_feedback", [False, True])
def test_fusion_step_builds_no_record_function_without_a_profiler(
        no_record_function, error_feedback):
    rt, params = _fusion(error_feedback)
    loss, grads = rt.train_step(params, [_batch()])
    assert torch.isfinite(loss)


def test_adamw_update_builds_no_record_function_without_a_profiler(
        no_record_function):
    rt, params = _fusion(False)
    _, grads = rt.train_step(params, [_batch()])
    opt = adamw(1e-3)
    new, _ = opt.update(grads, opt.init(params), params)
    assert len(tree_leaves(new)) == len(tree_leaves(params))


def _gspmd():
    params = causal_lm.init(CFG, torch.Generator().manual_seed(0))
    opt = adamw(1e-3)
    return make_train_step(CFG, opt), params, opt.init(params)


def test_gspmd_step_builds_no_record_function_without_a_profiler(
        no_record_function):
    step, params, state = _gspmd()
    _, _, metrics = step(params, state, _batch())
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("error_feedback", [False, True])
def test_fusion_step_emits_its_spans(error_feedback):
    rt, params = _fusion(error_feedback)
    rt.train_step(params, [_batch(1)])     # EF's residuals made outside
    _, prof = _profiled(lambda: rt.train_step(params, [_batch()]))
    names = _names(prof)
    subdags = rt.prog.subdags
    edges = sum(len(sd.required_acti) for sd in subdags)
    assert len(subdags) > 2 and edges > 0
    assert names["rad.step"] == 1
    for i in range(len(subdags)):
        assert names[f"rad.fwd.s{i}"] == 1
        assert names[f"rad.bwd.s{i}"] == 1
    assert names[f"rad.fwd.s{len(subdags)}"] == 0
    assert names["rad.wire"] == 2 * edges      # forward and backward
    assert names["attn"] == CFG.n_layers
    assert names["optim.update"] == 0


def test_rad_spans_nest_inside_the_step():
    rt, params = _fusion(False)
    _, prof = _profiled(lambda: rt.train_step(params, [_batch()]))
    rad = [e for e in prof.events() if e.name.startswith("rad.")
           or e.name == "attn"]
    step = [e for e in rad if e.name == "rad.step"]
    assert len(step) == 1 and len(rad) > 1
    lo, hi = step[0].time_range.start, step[0].time_range.end
    for e in rad:
        assert lo <= e.time_range.start <= e.time_range.end <= hi, e.name


def test_optimizer_update_is_one_span_for_all_leaves():
    rt, params = _fusion(False)
    _, grads = rt.train_step(params, [_batch()])
    opt = adamw(1e-3)
    state = opt.init(params)
    _, prof = _profiled(lambda: opt.update(grads, state, params))
    assert len(tree_leaves(params)) > 1
    assert _names(prof)["optim.update"] == 1


def test_gspmd_step_emits_attention_and_update_spans():
    step, params, state = _gspmd()
    _, prof = _profiled(lambda: step(params, state, _batch()))
    names = _names(prof)
    assert names["attn"] == CFG.n_layers
    assert names["optim.update"] == 1
    assert names["rad.step"] == 0


@pytest.mark.parametrize("error_feedback", [False, True])
def test_numbers_are_bitwise_the_same_with_the_profiler_on(error_feedback):
    def run():
        rt, params = _fusion(error_feedback)
        rt.train_step(params, [_batch(1)])
        loss, grads = rt.train_step(params, [_batch()])
        opt = adamw(1e-3)
        new, _ = opt.update(grads, opt.init(params), params)
        return [loss] + tree_leaves(grads) + tree_leaves(new)

    off = run()
    on, _ = _profiled(run)
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_recorder_region_records_and_shows_in_the_profiler():
    rec = obs_trace.TraceRecorder()

    def region(track):
        with rec.region(obs_trace.CAT_ENCODE, "enc edge", track):
            pass
    region("stage0")
    _, prof = _profiled(lambda: region("stage1"))
    got = [(e.cat, e.name, e.track) for e in rec.events()]
    assert got == [(obs_trace.CAT_ENCODE, "enc edge", "stage0"),
                   (obs_trace.CAT_ENCODE, "enc edge", "stage1")]
    assert _names(prof)["enc edge"] == 1


def test_recorder_region_without_a_profiler_builds_no_record_function(
        no_record_function):
    rec = obs_trace.TraceRecorder()
    with rec.region(obs_trace.CAT_ENCODE, "enc edge", "stage0"):
        pass
    with obs_trace.TraceRecorder(enabled=False).region(
            obs_trace.CAT_ENCODE, "enc edge", "stage0"):
        pass
    assert len(rec) == 1
