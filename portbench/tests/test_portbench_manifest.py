"""BENCHMARK.json against the benchmark's contract, and discovery of every
configuration, traffic mix, limit file and per-layer metric by name."""
import json
import re

import pytest

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.manifest()


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24


def test_names_units_and_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in M["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert {"setup_s"} <= {e["name"] for e in M["end_to_end"]}
    for e in M["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_config_is_used_and_names_its_file():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        cfg = json.load(open(manifest.ROOT / c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and NAME.match(key)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_found_by_name(cell):
    c = manifest.cell(cell)
    assert c["workload"]["chips"] == 1
    assert c["traffic"]["micro_batches"] == 1
    assert "grad_gap" in c["limits"]
    assert {"change_gap", "change_gap_median"} & set(c["limits"])
    assert {e["name"] for e in c["end_to_end"]} == {
        "tokens_per_s", "peak_mem_gb", "setup_s"}
    assert c["per_layer"]


@pytest.mark.parametrize("entry", M["per_layer"], ids=lambda e: e["name"])
def test_metric_module_declares_its_entry(entry):
    mod = manifest.metric_module(entry["name"])
    assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["source"], entry["moves"])
    assert callable(mod.read)
    moved = {e["name"] for e in M["end_to_end"]}
    assert entry["moves"] in moved
    for w in entry["workloads"]:
        assert w in {x["name"] for x in M["workloads"]}


def test_every_metric_file_is_listed():
    assert set(manifest.metric_names()) == {e["name"] for e in M["per_layer"]}
