"""The port's dry run (``repro_torch.launch.dryrun``) and HLO-text parser
(``repro_torch.analysis.hlo``) against the JAX package's, on the CPU.

The HLO functions are regular expressions and arithmetic: on
``tests/test_analysis.py``'s synthetic module and on the module text JAX
compiles for a small ``lax.scan`` program they must give JAX's numbers
exactly.

The dry run assembles every arch × input shape on both production meshes
with ``meta`` tensors, in bf16 as the JAX dry run does.  For each record:
the status is the JAX dry run's (``skipped`` exactly where the registry
skips the shape; ``ok`` otherwise), ``mem.argument_bytes`` equals the same
sum taken over the shardings JAX's ``build_jitted`` jits its step with
(read from ``fn._jit_info``, a private jax 0.9 field, as
``test_torch_sharding.py`` does), ``model_flops_total`` equals JAX's, and
every field only XLA's compile gives is ``None`` and named in
``not_measured`` — no stand-in number anywhere.
"""
import dataclasses
import functools
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.analysis import hlo as j_hlo  # noqa: E402
from repro.analysis.model_flops import model_flops as j_model_flops  # noqa: E402,E501
from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import resolve as j_resolve  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.distributed import steps as j_steps  # noqa: E402
from repro_torch.analysis import hlo as t_hlo  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from test_analysis import SYNTH_HLO  # noqa: E402
from test_torch_sharding import _j_flat, _j_in_shardings  # noqa: E402

COMBOS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
# the record's fields that only XLA's compile gives
COMPILER_ONLY = ("mem.output_bytes", "mem.temp_bytes", "mem.alias_bytes",
                 "mem.peak_per_device", "flops_per_device",
                 "bytes_per_device", "collective_bytes_per_device",
                 "collective_breakdown", "lower_s", "compile_s", "roofline",
                 "hlo_path")


# ------------------------------------------------------------------- hlo --
@functools.lru_cache(maxsize=None)
def _scan_hlo() -> str:
    """The compiled module text of a small ``lax.scan`` program (a while
    loop of 7 trips, one nested in another of 3)."""
    def inner(c, x):
        return c * 1.5 + x, c.sum()

    def outer(c, xs):
        c, ys = jax.lax.scan(inner, c, xs)
        return c, ys

    def f(c, xss):
        return jax.lax.scan(outer, c, xss)

    c = jnp.ones((4, 8), jnp.float32)
    xss = jnp.ones((3, 7, 4, 8), jnp.float32)
    return jax.jit(f).lower(c, xss).compile().as_text()


def _comps(mod, text):
    return {k: dataclasses.asdict(v)
            for k, v in mod.parse_hlo_computations(text).items()}


@pytest.mark.parametrize("which", ["synthetic", "scan"])
def test_hlo_functions_equal_jax(which):
    text = SYNTH_HLO if which == "synthetic" else _scan_hlo()
    assert _comps(t_hlo, text) == _comps(j_hlo, text)
    comps_t = t_hlo.parse_hlo_computations(text)
    trips = t_hlo.while_trip_counts(comps_t)
    assert trips == j_hlo.while_trip_counts(
        j_hlo.parse_hlo_computations(text))
    assert t_hlo._multipliers(comps_t) == j_hlo._multipliers(
        j_hlo.parse_hlo_computations(text))
    assert t_hlo.collective_bytes(text) == j_hlo.collective_bytes(text)
    assert t_hlo.collective_breakdown(text) == \
        j_hlo.collective_breakdown(text)
    if which == "synthetic":
        per_tensor = 8 * 16 * 4
        assert trips["region_body.2"] == 12
        assert t_hlo.collective_bytes(text) == per_tensor * 2 * 12 + \
            per_tensor
    else:
        assert sorted(trips.values()) == [3, 7]


# --------------------------------------------------------------- dry run --
def _j_argument_bytes(arch, shape_name, multi_pod):
    """The sum over the shardings JAX's ``build_jitted`` jits its step
    with, for the JAX dry run's bf16 config, rules and mesh."""
    entry, shape = j_resolve(arch), INPUT_SHAPES[shape_name]
    cfg = entry.full.replace(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                             remat=shape.kind == "train")
    mesh = AbstractMesh(*MESHES[multi_pod])
    rules = {}
    if shape.global_batch < dict(mesh.shape).get("data", 1):
        rules["batch"] = None
    with j_sh.use_mesh(mesh, rules):
        fn, args, _ = j_steps.build_jitted(cfg, mesh, shape)
    leaves, shardings = _j_flat(args), _j_flat(_j_in_shardings(fn))
    assert leaves.keys() == shardings.keys()
    return sum(math.prod(shardings[k].shard_shape(tuple(v.shape)))
               * np.dtype(v.dtype).itemsize for k, v in leaves.items()), \
        j_model_flops(cfg, shape)


def _nested(rec, dotted):
    for part in dotted.split("."):
        rec = rec[part]
    return rec


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_dryrun_record_equal_jax(arch, shape_name, multi_pod, tmp_path):
    rec = dryrun.run_one(arch, shape_name, multi_pod, out_dir=str(tmp_path))
    entry = j_resolve(arch)
    if shape_name not in entry.shapes:
        assert rec == {"arch": arch, "shape": shape_name,
                       "status": "skipped", "note": entry.skip_notes}
        assert list(tmp_path.iterdir()) == []
        return
    assert rec["status"] == "ok", rec.get("traceback")
    mesh_name = "2x16x16" if multi_pod else "16x16"
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"],
            rec["kind"], rec["unroll"]) == \
        (arch, shape_name, mesh_name, 512 if multi_pod else 256,
         INPUT_SHAPES[shape_name].kind, False)
    arg_bytes, flops = _j_argument_bytes(arch, shape_name, multi_pod)
    assert rec["mem"]["argument_bytes"] == arg_bytes > 0
    assert rec["model_flops_total"] == flops
    assert rec["not_measured"]["fields"] == list(COMPILER_ONLY)
    assert "no compiler" in rec["not_measured"]["why"]
    for field in COMPILER_ONLY:
        assert _nested(rec, field) is None, field
    path = tmp_path / f"{arch}__{shape_name}__{mesh_name}.json"
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert json.loads(path.read_text()) == rec


def test_dryrun_file_names_and_overrides(tmp_path):
    rec = dryrun.run_one("mixtral-8x7b", "train_4k", False,
                         out_dir=str(tmp_path), unroll=True,
                         overrides_name="moe_w")
    assert rec["status"] == "ok" and rec["unroll"] is True
    assert [p.name for p in tmp_path.iterdir()] == \
        ["mixtral-8x7b__train_4k__16x16__unroll__moe_w.json"]
    assert dryrun.record_path("o", "a", "s", "16x16") == "o/a__s__16x16.json"


def _main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["dryrun"] + argv)
    with pytest.raises(SystemExit) as ei:
        dryrun.main()
    return ei.value.code


def test_dryrun_main_exit_codes(monkeypatch, tmp_path, capsys):
    out = str(tmp_path / "ok")
    argv = ["--arch", "llama3-8b", "--shape", "decode_32k", "--multi-pod",
            "both", "--out", out]
    assert _main(monkeypatch, argv) == 0
    assert sorted(p.name for p in (tmp_path / "ok").iterdir()) == \
        ["llama3-8b__decode_32k__16x16.json",
         "llama3-8b__decode_32k__2x16x16.json"]
    assert "dryrun_ok" in capsys.readouterr().err
    assert _main(monkeypatch, argv + ["--skip-existing"]) == 0
    assert capsys.readouterr().err.count("dryrun_cached") == 2

    import repro_torch.distributed.steps as steps

    def broken(*a, **kw):
        raise RuntimeError("forced")

    monkeypatch.setattr(steps, "build_jitted", broken)
    assert _main(monkeypatch, ["--arch", "llama3-8b", "--shape",
                               "train_4k", "--out",
                               str(tmp_path / "bad")]) == 1
    rec = json.loads((tmp_path / "bad" /
                      "llama3-8b__train_4k__16x16.json").read_text())
    assert rec["status"] == "fail" and rec["error"] == "RuntimeError: forced"
    assert "dryrun_fail" in capsys.readouterr().err
