"""A block family is a file: the harness reads each layer's leaves,
reference forward, FLOPs and CPU size from ``families/<family>.py`` and
builds the port's ``ModelCfg`` from the configuration's own keys.

``parent_values.json`` holds what the harness gave for both configurations
at their cells' sizes before the blocks moved into family files; the
values now must equal it exactly."""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness import manifest, program, weights, yardstick
from portbench.reference import compare, planner
from smallcells import NAMES, small

PARENT = json.loads((Path(__file__).parent / "parent_values.json").read_text())
CONFIGS = sorted(PARENT)


def config(name):
    return json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())


def listed(specs):
    return [[list(p), list(s), k, sc] for p, s, k, sc in specs]


@pytest.mark.parametrize("entry", manifest.manifest()["configs"],
                         ids=lambda e: e["name"])
def test_every_configuration_names_a_family_file(entry):
    fam = manifest.family(config(entry["name"]))
    for fn in ("block_specs", "block", "block_flops", "small"):
        assert callable(getattr(fam, fn))


@pytest.mark.parametrize("layout", ["fusion", "gspmd"])
@pytest.mark.parametrize("name", CONFIGS)
def test_specs_equal_the_parents_path_by_path(name, layout):
    want = PARENT[name][f"specs_{layout}"]
    got = listed(weights.specs(config(name), layout, PARENT[name]["seq"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


@pytest.mark.parametrize("name", CONFIGS)
def test_op_chain_plans_codec_and_flops_equal_the_parents(name):
    cfg, want = config(name), PARENT[name]
    B, S = want["batch"], want["seq"]
    assert [list(o) for o in planner.op_chain(cfg, B, S)] == want["op_chain"]
    for comp in ("uniform", "adatopk"):
        plan = planner.plan(cfg, B, S, comp, 100.0)
        assert plan["stages"] == want[f"plan_{comp}"]["stages"]
        assert [[a, b, r] for (a, b), r in plan["edges"].items()] \
            == want[f"plan_{comp}"]["edges"]
        shapes = planner.codec_shapes(cfg, B, S, plan["edges"])
        assert [list(x) for x in shapes] == want[f"codec_shapes_{comp}"]
        assert yardstick.step_codec_bytes(shapes) == want[f"codec_bytes_{comp}"]
    assert yardstick.step_flops(cfg, B, S) == want["step_flops"]


@pytest.mark.parametrize("name", CONFIGS)
def test_model_cfg_equals_the_parents_field_by_field(name):
    mc = program.model_cfg(config(name), PARENT[name]["seq"])
    got = {f.name: repr(getattr(mc, f.name)) for f in dataclasses.fields(mc)}
    assert got == PARENT[name]["model_cfg"]


def test_model_cfg_passes_the_expert_fields():
    cfg = dict(config("gpt2-xl"), family="moe", n_experts=64, top_k=6,
               n_shared_experts=2)
    mc = program.model_cfg(cfg, 1024)
    assert (mc.family, mc.n_experts, mc.top_k, mc.n_shared_experts) == (
        "moe", 64, 6, 2)


def test_model_cfg_refuses_a_family_the_port_does_not_build():
    with pytest.raises(ValueError, match="parallel"):
        program.model_cfg(dict(config("gpt2-xl"), family="parallel"), 1024)


@pytest.mark.parametrize("key", ["kv_lora_rank", "layer_norm_epsilon"])
def test_model_cfg_refuses_a_key_that_means_nothing_to_the_port(key):
    with pytest.raises(KeyError, match=key):
        program.model_cfg(dict(config("gpt2-xl"), **{key: 1}), 1024)


def test_the_gspmd_layout_refuses_unlike_layers(monkeypatch):
    dense = manifest.family_module("dense")
    cfg = small(NAMES[0])["config"]

    def block_specs(cfg, i):
        out = dense.block_specs(cfg, i)
        return out if i == 0 else out[:-1]
    monkeypatch.setattr(manifest, "family",
                        lambda cfg: SimpleNamespace(block_specs=block_specs))
    assert len(weights.specs(cfg, "fusion", 32)) > 0
    with pytest.raises(ValueError, match="layer 1"):
        weights.specs(cfg, "gspmd", 32)


@pytest.mark.parametrize("name", NAMES)
def test_a_frozen_step_reads_one_on_both_norm_gaps(name):
    c = small(name)
    seed = 2 ** 35 + 1
    r = cell_mod.Run(c, seed, torch.device("cpu"), fault="frozen")
    ref = cell_mod.reference_readings(c["config"], c["traffic"], seed,
                                      r.check_batches(), torch.device("cpu"))
    nums = compare.numbers(r.readings, ref, r.plan_diff())
    assert nums["grad_gap"] == 1.0 and nums["change_gap"] == 1.0


# GPT-J's parallel block, x + attn(n(x)) + mlp(n(x)), with a loss term: a
# family the harness has never seen, written as a file beside dense.py.
PARALLEL = '''
"""GPT-J's parallel block: x + attn(n(x)) + mlp(n(x)), one norm; each
layer adds aux_loss_weight times the mean square of its output to the
loss."""
import math

import torch.nn.functional as F

from portbench.harness.weights import norm_specs
from portbench.reference.model import norm, rotary


def block_specs(cfg, i):
    d, dff = cfg["d_model"], cfg["d_ff"]
    q = cfg["n_heads"] * cfg["head_dim"]
    s = 1 / math.sqrt(d)
    return norm_specs(("ln",), d, cfg) + [
        (("wqkv",), (d, 3 * q), "normal", s),
        (("wo",), (q, d), "normal", 1 / math.sqrt(q)),
        (("up",), (d, dff), "normal", s),
        (("down",), (dff, d), "normal", 1 / math.sqrt(dff))]


def block(cfg, p, x, i, split=False):
    B, S, _ = x.shape
    H, hd = cfg["n_heads"], cfg["head_dim"]
    h = norm(cfg, p["ln"], x)
    q, k, v = (h @ p["wqkv"]).view(B, S, 3, H, hd).unbind(2)
    q, k = rotary(q, cfg["rope_theta"]), rotary(k, cfg["rope_theta"])
    a = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2).reshape(B, S, H * hd)
    out = x + a @ p["wo"] + F.gelu(h @ p["up"], approximate="tanh") @ p["down"]
    return out, cfg["aux_loss_weight"] * out.pow(2).mean()


def block_flops(cfg, i, batch, seq):
    d, dff, q = cfg["d_model"], cfg["d_ff"], cfg["n_heads"] * cfg["head_dim"]
    T = batch * seq
    return 2.0 * T * (3 * d * q + q * d + 2 * d * dff) + 4.0 * T * seq * q


def small(cfg):
    return dict(cfg, n_layers=3, d_model=32, n_heads=2, n_kv_heads=2,
                head_dim=16, d_ff=64, vocab=300, vocab_pad_to=128)
'''

GPTJ = {"name": "gpt-j-6b", "source": "https://huggingface.co/EleutherAI/gpt-j-6b",
        "family": "parallel", "n_layers": 28, "d_model": 4096, "n_heads": 16,
        "n_kv_heads": 16, "head_dim": 256, "d_ff": 16384, "vocab": 50400,
        "vocab_pad_to": 256, "norm": "layernorm", "norm_eps": 1e-05,
        "act": "gelu", "rope_fraction": 1.0, "rope_theta": 10000.0,
        "max_seq": 2048, "aux_loss_weight": 1.0, "reduced": {}}

DRIVE = '''
import json, math, sys, torch
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/portbench/tests"]
from smallcells import small
from portbench.harness import manifest, weights, yardstick
from portbench.reference import model, planner

CPU = torch.device("cpu")
out = {}
c = small("gptj.fusion-adatopk.b2s1024")
cfg, tr = c["config"], c["traffic"]
B, S = tr["batch"], tr["seq"]
out["small"] = [cfg["n_layers"], cfg["d_model"], B, S]
fam = manifest.family_module("parallel")
tokens = torch.randint(0, cfg["vocab"], (B, S), generator=torch.Generator().manual_seed(1))
for layout in ("fusion", "gspmd"):
    params = weights.make(cfg, layout, S, 7, CPU)
    out[layout + "_leaves"] = [n for n, _ in model.leaves(params)]
    quiet = dict(cfg, aux_loss_weight=0.0)
    with torch.no_grad():
        loss, ce = (float(model.loss(k, layout, params, tokens, tokens, {}))
                    for k in (cfg, quiet))
        emb = params["embed"]["tok"]["table"] if layout == "fusion" \\
            else params["embed"]["table"]
        x, terms = emb[tokens], 0.0
        blocks = [params[f"block_{i}"] for i in range(cfg["n_layers"])] \\
            if layout == "fusion" else model._unstack(params["blocks"])
        for i, p in enumerate(blocks):
            x, t = fam.block(cfg, p, x, i)
            terms += float(t)
    out[layout + "_term"] = [loss, ce, terms]
    got = model.train_readings(cfg, layout, tr, params, [(tokens, tokens)] * 2, {})
    g0 = model.train_readings(quiet, layout, tr, weights.make(cfg, layout, S, 7, CPU),
                              [(tokens, tokens)] * 2, {})
    out[layout + "_grads"] = [sorted(got["g1"]) == sorted(out[layout + "_leaves"]),
                              all(math.isfinite(v) and v > 0 for v in got["g1"].values()),
                              got["g1"] != g0["g1"]]
full = json.load(open(sys.argv[1] + "/portbench/configs/gpt-j-6b.json"))
plan = planner.plan(full, 2, 1024, "adatopk", 100.0)
out["stages"] = sum(len(s) for s in plan["stages"])
out["edges"] = [[a, b, r] for (a, b), r in plan["edges"].items()]
out["codec"] = planner.codec_shapes(full, 2, 1024, plan["edges"])
out["flops"] = yardstick.step_flops(full, 2, 1024)
out["loaded"] = sorted({m.split(".")[0] for m in sys.modules} & {"repro", "repro_torch", "jax"})
print(json.dumps(out))
'''


def test_a_new_family_joins_by_adding_files(tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*.py")}
    (bench / "families" / "parallel.py").write_text(PARALLEL)
    (bench / "configs" / "gpt-j-6b.json").write_text(json.dumps(GPTJ))
    (bench / "limits" / "gptj.fusion-adatopk.b2s1024.json").write_text(
        json.dumps({"grad_gap": 1e-5, "change_gap": 1e-5}))
    m = manifest.manifest()
    m["configs"].append({"name": "gpt-j-6b", "source": GPTJ["source"],
                         "file": "portbench/configs/gpt-j-6b.json",
                         "reduced": [], "why": "a parallel block"})
    m["workloads"].append({"name": "gptj.fusion-adatopk.b2s1024",
                           "config": "gpt-j-6b",
                           "traffic": "fusion-adatopk-b2s1024", "chips": 1,
                           "why": "a parallel block"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "drive.py").write_text(DRIVE)
    got = subprocess.run([sys.executable, str(tmp_path / "drive.py"),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=240)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert all(p.read_bytes() == b for p, b in before.items())

    assert out["small"] == [3, 32, 4, 32]
    assert len(out["fusion_leaves"]) == 1 + 3 * 6 + 3
    assert "block_2/wqkv" in out["fusion_leaves"]
    assert "blocks/wqkv" in out["gspmd_leaves"]
    for layout in ("fusion", "gspmd"):
        loss, ce, terms = out[layout + "_term"]
        assert terms > 1e-3 and loss == pytest.approx(ce + terms, abs=1e-5)
        assert out[layout + "_grads"] == [True, True, True]
    T, d, q, dff, V = 2 * 1024, 4096, 16 * 256, 16384, 50432
    blk = 2 * T * (3 * d * q + q * d + 2 * d * dff) + 4 * T * 1024 * q
    assert out["flops"] == 3 * (28 * blk + 2 * T * d * V)
    assert out["stages"] == 28 + 3
    assert out["edges"] == [["block_6", "block_7", 300.0]]
    assert out["codec"] == [[T * d, 14]]
    assert out["loaded"] == []
