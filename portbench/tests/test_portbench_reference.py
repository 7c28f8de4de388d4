"""The plain reference against the program at the cells' small sizes on
the CPU, the frozen planner against the program's at the cells' own
sizes, and the verdict on planted faults and on the bfloat16 control."""
import time

import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness import manifest
from portbench.reference import compare, model, planner
from smallcells import NAMES, small

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", NAMES)
def test_reference_follows_the_program(name):
    c = small(name)
    r = cell_mod.Run(c, 2 ** 31 + 7, CPU)
    ref = cell_mod.reference_readings(c["config"], c["traffic"], 2 ** 31 + 7,
                                      r.check_batches(), CPU)
    nums = compare.numbers(r.readings, ref, r.plan_diff())
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-3
    assert nums.get("plan_diff", 0) == 0


@pytest.mark.parametrize("name", [n for n in NAMES if "fusion" in n])
def test_frozen_planner_matches_the_program_at_full_size(name):
    from repro_torch.core import (network, plan_adatopk, plan_uniform,
                                  schedule_opfence)
    from repro_torch.models.opgraph_models import gpt_opgraph
    from portbench.harness.program import model_cfg
    c = manifest.cell(name)
    cfg, tr = c["config"], c["traffic"]
    B, S = tr["batch"], tr["seq"]
    graph = gpt_opgraph(model_cfg(cfg, S), B, S)
    prof = graph.annotate({"tokens": (B, S), "labels": (B, S)})
    cluster = network.paper_testbed(1, seed=0)
    sch = schedule_opfence(graph, prof, cluster)
    plan = (plan_uniform(graph, sch.placement, tr["ratio"])
            if tr["compress"] == "uniform" else
            plan_adatopk(graph, prof, cluster, sch.placement, tr["ratio"]))
    stages = [[n for n in seg if n not in ("tokens", "labels")]
              for seg in (sch.assignment[d] for d in sch.stage_devices())]
    ref = planner.plan(cfg, B, S, tr["compress"], tr["ratio"])
    assert compare.plan_diff((stages, plan.edge_ratio), ref) == 0


def test_wire_keeps_exactly_k_with_ties_in_index_order():
    x = torch.tensor([3.0, -3.0, 1.0, 3.0, 0.5, -2.0, 3.0, 0.0] * 512)
    out = model.topk_blocks(x, 3).reshape(-1)
    assert int((out != 0).sum()) == 3
    assert out[:4].tolist() == [3.0, -3.0, 0.0, 3.0]


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in NAMES for f in ("frozen", "half_batch", "dense_wire")
    if f != "dense_wire" or "fusion" in n])
def test_a_broken_timed_path_reads_not_correct(name, fault):
    out = cell_mod.run(name, 11, 0.2, False, CPU, time.time(), fault=fault,
                       cell=small(name))
    assert out["correct"] is False


def test_a_sound_run_reads_correct_and_reports_its_metrics():
    name = "gpt2xl.gspmd.b2s1024"
    out = cell_mod.run(name, 2 ** 40 + 3, 0.2, False, CPU, time.time(),
                       cell=small(name))
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"tokens_per_s", "peak_mem_gb", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", NAMES)
def test_the_bfloat16_control_reads_not_correct(name):
    c = small(name)
    batches = cell_mod.check_batches(c, 5, CPU)
    ref = cell_mod.reference_readings(c["config"], c["traffic"], 5, batches,
                                      CPU)
    ctl = cell_mod.reference_readings(c["config"], c["traffic"], 5, batches,
                                      CPU, dtype=torch.bfloat16)
    assert not compare.verdict(compare.numbers(ctl, ref), c["limits"])
