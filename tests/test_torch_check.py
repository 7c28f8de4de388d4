"""The port's check package (``repro_torch.check``: the graph, trace-order,
bench, docs and lint checkers, the ``python -m repro_torch.check`` CLI and
the package's lazy loader) against the JAX package's, on the CPU.

Every checker is Python over the same data in both packages, so the
findings must be EQUAL — code, location, message and severity — with one
exception: a lint message that names the package or its kernels names the
port's (``repro_torch.obs``, "the CUDA kernels").  The lint's port rule
(``foreign-import``) and the two packages' module trees are checked here
too.
"""
import importlib
import io
import json
import os
import pathlib
import sys
import types
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from helpers import mlp_chain as j_mlp_chain  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from test_torch_elastic import t_mlp_chain  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "baselines" / "BENCH_baseline_joint.json"


def _side(pkg, mlp):
    mods = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "check", "check.graph", "check.traceorder", "check.bench",
        "check.docs", "check.lint", "check.__main__", "core.network",
        "core.scheduler", "core.executor", "core.compression",
        "core.opgraph", "obs.trace", "obs.export")}
    ns = types.SimpleNamespace(**{k.replace(".", "_"): v
                                  for k, v in mods.items()})
    ns.mlp_chain = mlp
    return ns


J = _side("repro", j_mlp_chain)
T = _side("repro_torch", t_mlp_chain)


def _f(findings):
    return [(f.code, f.where, f.message, f.severity) for f in findings]


def _toy(m, n_layers=8, n_dev=6):
    g, shapes, _, _ = m.mlp_chain(n_layers=n_layers, d=16)
    prof = g.annotate(shapes)
    cluster = m.core_network.geo_random(n_dev, n_sites=2, seed=0)
    sched = m.core_scheduler.schedule_opfence(g, prof, cluster)
    return g, shapes, prof, cluster, sched


# ----------------------------------------------------------------- graph --
def _graph_case(m, case):
    g, shapes, prof, _, _ = _toy(m, n_layers=4 if case != "clean" else 8)
    if case == "cycle":
        g.nodes["l0"].args = ("x", "l2")     # back edge: l0 <- l2 <- l1 <- l0
        return m.check_graph.check_graph(g)
    if case == "unreachable":
        OpNode = m.core_opgraph.OpNode
        g.add(OpNode("orphan", m.core_opgraph.OpType.PARAMETRIC,
                     args=("l3",), out_shape_fn=lambda s: s))
        return m.check_graph.check_graph(g, shapes)
    return (m.check_graph.check_graph(g, shapes)
            + m.check_graph.check_profiles(g, prof, shapes))


@pytest.mark.parametrize("case,code", [("cycle", "cycle"),
                                       ("unreachable",
                                        "unreachable-from-loss"),
                                       ("clean", None)])
def test_graph_checks_equal_jax(case, code):
    j, t = _f(_graph_case(J, case)), _f(_graph_case(T, case))
    assert t == j
    if code is None:
        assert t == []
    else:
        assert code in {c for c, *_ in t}
    if case == "unreachable":
        assert [w for c, w, *_ in t if c == code] == ["orphan"]


# ----------------------------------------------------------- trace order --
def _trace_case(m, case):
    rec = m.obs_trace.TraceRecorder()
    if case == "overlapping_sends":
        rec.span("link.transfer", "Fxfer.mb0", "link 0->1", 0.0, 2.0)
        rec.span("link.transfer", "Fxfer.mb1", "link 0->1", 1.0, 3.0)
        rec.span("stage.fwd", "F1.mb0", "dev1", 2.0, 4.0)
        rec.span("stage.fwd", "F1.mb1", "dev1", 4.0, 6.0)
    elif case == "compute_before_transfer":
        rec.span("link.transfer", "Fxfer.mb0", "link 0->1", 0.0, 5.0)
        rec.span("stage.fwd", "F1.mb0", "dev1", 3.0, 6.0)
    elif case == "nonmonotonic":
        rec.span("stage.fwd", "F0.mb1", "dev0", 5.0, 6.0)
        rec.span("stage.fwd", "F0.mb0", "dev0", 0.0, 1.0)
    else:                                  # a simulated iteration, AdaTopK
        g, _, prof, cluster, sched = _toy(m)
        plan = m.core_compression.plan_adatopk(g, prof, cluster,
                                               sched.placement, 100.0)
        m.core_executor.simulate_iteration(g, prof, sched, cluster, plan,
                                           n_micro=3, trace=rec)
    return rec


@pytest.mark.parametrize("case,code,where", [
    ("overlapping_sends", "overlap", "link 0->1"),
    ("compute_before_transfer", "compute-before-transfer", "dev1/F1.mb0"),
    ("nonmonotonic", "nonmonotonic-track", "dev0"),
    ("simulated", None, None)])
def test_trace_order_equal_jax(case, code, where):
    j = _f(J.check_traceorder.check_trace_order(_trace_case(J, case)
                                                .events()))
    t = _f(T.check_traceorder.check_trace_order(_trace_case(T, case)
                                                .events()))
    assert t == j
    if code is None:
        assert [x for x in t if x[3] == "error"] == []
        return
    assert any(c == code and w == where for c, w, *_ in t)
    with pytest.raises(T.check.TraceOrderError) as ei:
        T.check_traceorder.verify_trace(_trace_case(T, case))
    assert code in ei.value.codes


def _event_key(e):
    return (e.clock, e.ts, e.seq, e.phase, e.cat, e.name, e.track, e.dur,
            json.dumps(e.args, sort_keys=True, default=str))


def test_trace_order_file_round_trips_across_packages(tmp_path):
    """A JSONL or Chrome trace written by either package loads in the
    other to the same events, and verifies clean in both."""
    written = {}
    for name, m in (("jax", J), ("torch", T)):
        g, _, prof, cluster, sched = _toy(m)
        rec = m.obs_trace.TraceRecorder()
        m.core_executor.simulate_iteration(g, prof, sched, cluster,
                                           n_micro=2, trace=rec)
        jsonl = tmp_path / f"{name}.jsonl"
        chrome = tmp_path / f"{name}.json"
        m.obs_export.write_jsonl(rec, str(jsonl))
        m.obs_export.write_chrome_trace(rec, str(chrome))
        written[name] = (str(jsonl), str(chrome))
    for paths in written.values():
        for path in paths:
            j = J.check_traceorder.load_trace_events(path)
            t = T.check_traceorder.load_trace_events(path)
            assert j and sorted(map(_event_key, t)) == \
                sorted(map(_event_key, j))
            assert [f for f in T.check_traceorder.verify_trace(path)
                    if f.severity == "error"] == []
    assert sorted(map(_event_key, T.check_traceorder.load_trace_events(
        written["torch"][0]))) == sorted(map(
            _event_key, J.check_traceorder.load_trace_events(
                written["jax"][0])))


# ----------------------------------------------------------------- bench --
POISONED = {
    "committed": None,
    "empty": {"result": {}},
    "nan": {"result": {"joint": {"pace": float("nan"), "phi": 1.0}}},
    "zero_tracked": {"result": {"joint": {"pace": 0.0}}},
    "no_tracked": {"result": {"joint": {"other": 1.0}}},
    "not_a_mapping": [1, 2],
}


@pytest.mark.parametrize("case", list(POISONED))
def test_bench_checks_equal_jax(case):
    payload = POISONED[case]
    if payload is None:
        payload = json.loads(BASELINE.read_text())
    j = _f(J.check_bench.check_bench_result(payload, source=case))
    t = _f(T.check_bench.check_bench_result(payload, source=case))
    assert t == j
    assert T.check_bench.TRACKED_DEFAULT == J.check_bench.TRACKED_DEFAULT
    if case == "committed":
        assert t == []
        return
    assert t
    with pytest.raises(T.check.BaselineCheckError):
        T.check_bench.verify_bench_result(payload)


# ------------------------------------------------------------------ docs --
def test_docs_findings_equal_jax_live_and_broken(tmp_path):
    assert _f(T.check_docs.check_docs()) == _f(J.check_docs.check_docs()) \
        == []
    assert T.check_docs.DEFAULT_DOCS == J.check_docs.DEFAULT_DOCS
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "a.md").write_text(
        "# Title\n\n## Sub section\n\n[ok](#sub-section) [x](#nope)\n"
        "[f](missing.md) [g](../README.md#title) [h](../README.md#gone)\n"
        "```\n[in fence](nowhere.md)\n```\n[web](https://example.com)\n")
    (tmp_path / "README.md").write_text("# Title\n[d](docs/a.md#sub-section)"
                                        "\n[e](docs/)\n")
    j = _f(J.check_docs.check_docs(str(tmp_path)))
    t = _f(T.check_docs.check_docs(str(tmp_path)))
    assert t == j
    assert sorted(c for c, *_ in t) == ["dead-anchor", "dead-anchor",
                                        "dead-link"]
    with pytest.raises(T.check.CheckError):
        T.check_docs.verify_docs(str(tmp_path))


# ------------------------------------------------------------------ lint --
LINT_SNIPPETS = [
    ("def f(link, numel, x):\n    import time\n    t0 = time.time()\n"
     "    return numel * x.itemsize + link.beta * numel\n", "core/rogue.py"),
    ("k = numel * itemsize\n", "core/compression.py"),
    ("def main():\n    print('ok')\n", "obs/x.py"),
    ("print('no')\n", "obs/x.py"),
    ("if __name__ == '__main__':\n    print('ok')\n", "obs/y.py"),
    ("print('cli')\n", "check/__main__.py"),
    ("def g(x):\n    return topk_mask(x, 4)\n", "distributed/steps.py"),
    ("def g(x):\n    return ops.topk_select(x, 4, use_kernel=True)\n",
     "core/rad.py"),
    ("x = 1\n", "serving/new.py"),
    ('"""Doc."""\nx = 1\n', "serving/new.py"),
    ("def broken(:\n", "core/x.py"),
]
# the port's messages name its own package and kernels
_PORT_WORDS = (("repro.obs", "repro_torch.obs"),
               ("the Pallas fast path and its cost telemetry",
                "the CUDA kernels and their cost telemetry"))


def _as_port(findings):
    out = []
    for code, where, msg, sev in findings:
        for a, b in _PORT_WORDS:
            msg = msg.replace(a, b)
        out.append((code, where, msg, sev))
    return out


@pytest.mark.parametrize("source,rel", LINT_SNIPPETS)
def test_lint_snippets_equal_jax(source, rel):
    j = _f(J.check_lint.lint_source(source, rel))
    t = _f(T.check_lint.lint_source(source, rel))
    assert t == _as_port(j)


def test_lint_rule_lists_equal_jax():
    for name in ("_ITEMSIZE_OK", "_LINKMATH_OK", "_WALLCLOCK_SCOPES",
                 "_LINK_ATTRS", "_DISPATCH_SCOPES", "_DISPATCH_FNS",
                 "_DOCSTRING_SCOPES"):
        assert getattr(T.check_lint, name) == getattr(J.check_lint, name)
    port = ROOT / "src" / "repro_torch"
    for rel in T.check_lint._ITEMSIZE_OK | T.check_lint._LINKMATH_OK:
        assert (port / rel).is_file(), rel


def test_live_port_tree_is_lint_clean():
    assert T.check_lint.repro_root() == str(ROOT / "src" / "repro_torch")
    assert [str(f) for f in T.check_lint.lint_tree()] == []
    assert T.check_lint.verify_lint() == []


@pytest.mark.parametrize("source,flagged", [
    ("import jax\n", True),
    ("import jax.numpy as jnp\n", True),
    ("from jax import lax\n", True),
    ("from repro.core import x\n", True),
    ("import repro.obs\n", True),
    ("from repro_torch.core import x\n", False),
    ("import repro_torch\n", False),
    ("from .core import x\n", False),
    ("import numpy as np\n", False),
])
def test_lint_foreign_import(source, flagged):
    findings = T.check_lint.lint_source(source, "core/x.py")
    assert [f.code for f in findings] == \
        (["foreign-import"] if flagged else [])
    if flagged:
        assert findings[0].where == "core/x.py:1"
    # the JAX package's lint has no such rule
    assert J.check_lint.lint_source(source, "core/x.py") == []


# ------------------------------------------------------------------- CLI --
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_check_config_equal_jax(arch):
    j = _f(J.check___main__.check_config(arch))
    t = _f(T.check___main__.check_config(arch))
    assert t == j
    assert [x for x in t if x[3] == "error"] == []


def _cli(m, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = m.check___main__.main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [["--all-configs"], ["--config",
                                                      "gpt2-xl", "--docs"]])
def test_check_cli_equal_jax(argv):
    rc_j, out_j = _cli(J, argv)
    rc_t, out_t = _cli(T, argv)
    assert rc_t == rc_j == 0
    assert out_t == out_j
    if argv == ["--all-configs"]:
        assert [ln.split(":")[0] for ln in out_t.splitlines()] == \
            [f"config {a}" for a in ARCH_IDS]


def test_check_cli_lint_and_failures(tmp_path):
    """Bare, the CLI runs ``--all-configs --lint`` over the port's tree;
    a bad trace or a poisoned baseline fails as in JAX."""
    rc, out = _cli(T, [])
    assert rc == 0 and out.splitlines()[-1] == "lint src/repro_torch: OK"
    lint_json = tmp_path / "lint.json"
    assert _cli(T, ["--lint-json", str(lint_json)])[0] == 0
    assert json.loads(lint_json.read_text()) == []
    rec = _trace_case(T, "overlapping_sends")
    bad_trace = tmp_path / "bad.jsonl"
    T.obs_export.write_jsonl(rec, str(bad_trace))
    poisoned = tmp_path / "poisoned.json"
    poisoned.write_text(json.dumps(POISONED["zero_tracked"]))
    for argv in (["--trace", str(bad_trace)], ["--bench", str(poisoned)],
                 ["--trace", str(tmp_path / "absent.jsonl")],
                 ["--bench", str(BASELINE)]):
        rc_j, out_j = _cli(J, argv)
        rc_t, out_t = _cli(T, argv)
        assert (rc_t, out_t) == (rc_j, out_j), argv
        assert rc_t == (0 if argv[1] == str(BASELINE) else 1)


# ------------------------------------------------------ package structure --
def test_lazy_names_equal_jax():
    assert T.check._LAZY == J.check._LAZY
    assert T.check.__all__ == J.check.__all__
    for name in T.check._LAZY:
        value = getattr(T.check, name)
        assert value.__module__.startswith("repro_torch.check."), name
        assert name in dir(T.check)
    with pytest.raises(AttributeError):
        getattr(T.check, "no_such_checker")


def test_check_package_loads_checkers_lazily():
    """Importing the package imports its errors and no checker."""
    import subprocess
    code = ("import sys; import repro_torch.check; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.check.')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "['repro_torch.check.errors']"


def test_module_trees_equal():
    """Every module of the JAX package has a counterpart at the same path
    in the port; the port's extra modules are its own."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    rel = lambda base: {str(p.relative_to(base)) for p in base.rglob("*.py")
                        if "__pycache__" not in p.parts}
    missing = sorted(rel(ref) - rel(port))
    assert missing == []
    # the package marker, the device resolver and the weight converter
    assert sorted(rel(port) - rel(ref)) == ["__init__.py",
                                            "checkpoint/convert.py",
                                            "device.py"]
