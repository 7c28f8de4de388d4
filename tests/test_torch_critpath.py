"""The port's trace analyzers (``repro_torch.obs.critpath``, ``whatif``,
``report``) and ``obs.export --check-order`` against the JAX package's, on
the CPU.

The analyzers are Python arithmetic over span logs, and the simulator,
planners and controller that produce those logs are framework-free in both
packages, so everything here must be EQUAL, not close: the recorded events,
the critical-path decompositions, blame tables, audits and busy
accounting, the what-if predictions and rankings, the rendered report and
the CLIs' output and exit codes.

The heavyweight fixture is ``tests/test_critpath.py``'s ``closed_loop``
(fat-pipe topology, a slowlink degradation, the calibrated joint
controller with the whole obs kit), run through both packages; the port's
controller is sim-only on the CPU (``device="cpu"``).
"""
import dataclasses
import importlib
import io
import json
import types
from contextlib import redirect_stderr, redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from helpers import mlp_chain as j_mlp_chain  # noqa: E402
from test_torch_elastic import t_mlp_chain  # noqa: E402


def _side(pkg, mlp, controller_kw):
    mods = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "configs.base", "core.network", "core.compression", "core.costmodel",
        "core.executor", "core.scheduler", "elastic",
        "models.opgraph_models", "obs", "obs.critpath", "obs.whatif",
        "obs.export", "obs.report", "obs.trace")}
    ns = types.SimpleNamespace(**{k.replace(".", "_"): v
                                  for k, v in mods.items()})
    ns.mlp_chain = mlp
    ns.controller_kw = controller_kw
    return ns


J = _side("repro", j_mlp_chain, {})
T = _side("repro_torch", t_mlp_chain, {"device": "cpu"})


def _ev(e):
    return dataclasses.asdict(e)


def _events(events):
    """Recorder events keyed as ``obs.trace`` orders them."""
    return sorted((_ev(e) for e in events),
                  key=lambda d: (d["clock"], d["ts"], d["seq"]))


# ---------------------------------------------------------- hand-built DAG --
def _span(m, seq, cat, name, track, ts, dur, **args):
    return m.obs_trace.TraceEvent(seq=seq, clock=m.obs_trace.CLOCK_SIM,
                                  phase="X", cat=cat, name=name, track=track,
                                  ts=ts, dur=dur,
                                  args={"step": 0, "epoch": 0, **args})


def _dag(m, case):
    tr = m.obs_trace
    s = lambda *a: _span(m, *a)
    if case == "chain":
        return [s(0, tr.CAT_FWD, "F0.mb0", "dev0", 0.0, 1.0),
                s(1, tr.CAT_ENCODE, "Fenc.mb0", "codec0", 1.0, 0.5),
                s(2, tr.CAT_TRANSFER, "Fxfer.mb0", "link 0->1", 1.5, 1.0),
                s(3, tr.CAT_FWD, "F1.mb0", "dev1", 2.5, 1.5)]
    if case == "stall":
        return [s(0, tr.CAT_FWD, "F0.mb0", "dev0", 0.0, 1.0),
                s(1, tr.CAT_FWD, "F1.mb0", "dev1", 2.0, 1.0)]
    if case == "causal_tie":
        return [s(0, tr.CAT_FWD, "F0.mb0", "dev0", 0.0, 1.0),
                s(1, tr.CAT_FWD, "F5.mb0", "dev5", 0.0, 1.0),
                s(2, tr.CAT_TRANSFER, "Fxfer.mb0", "link 0->1", 1.0, 1.0),
                s(3, tr.CAT_FWD, "F1.mb0", "dev1", 2.0, 1.0)]
    return [s(0, tr.CAT_FWD, "F0.mb0", "dev0", 0.0, 1.0),          # shares
            s(1, tr.CAT_TRANSFER, "Fxfer.mb0", "link 0->1", 1.0, 3.0),
            s(2, tr.CAT_FWD, "F1.mb0", "dev1", 4.0, 1.0)]


def _analysis(m, events):
    cp = m.obs_critpath
    decomps = cp.analyze(events)
    rows = cp.blame(decomps)
    busy = cp.busy_accounting(events)
    return {"decomps": [d.to_dict() for d in decomps],
            "blame": [r.to_dict() for r in rows],
            "audit": cp.audit(decomps), "busy": busy,
            "render": cp.render_blame(rows),
            "artifact": cp.to_artifact(decomps, rows, busy, source="s"),
            "report": m.obs_report.build_report(events)}


@pytest.mark.parametrize("case", ["chain", "stall", "causal_tie", "shares"])
def test_hand_built_dags_equal_jax(case):
    j, t = _analysis(J, _dag(J, case)), _analysis(T, _dag(T, case))
    assert t == j
    assert t["audit"] == [] and len(t["decomps"]) == 1
    d = t["decomps"][0]
    if case == "chain":
        assert [s["name"] for s in d["path"]] == \
            ["F0.mb0", "Fenc.mb0", "Fxfer.mb0", "F1.mb0"]
        assert d["stall"] == 0.0 and d["makespan"] == 4.0
    elif case == "stall":
        assert d["stall"] == 1.0
    elif case == "causal_tie":
        assert "dev0" in d["compute"] and "dev5" not in d["compute"]
    else:
        assert t["blame"][0]["track"] == "link 0->1"
        assert t["blame"][0]["share"] == 3.0 / 5.0


def _sim_trace(m):
    g, shapes, _, _ = m.mlp_chain(n_layers=6, d=16, batch=4)
    prof = g.annotate(shapes)
    cluster = m.core_network.homogeneous_lan(n=4)
    sch = m.core_scheduler.schedule_opfence(g, prof, cluster)
    rec = m.obs.TraceRecorder()
    sim = m.core_executor.simulate_iteration(g, prof, sch, cluster,
                                             n_micro=4, trace=rec)
    totals = {"sim_device_busy_seconds": sum(sim.device_busy),
              "sim_link_busy_seconds": sim.link_busy,
              "sim_compress_busy_seconds": sim.compress_busy}
    return rec, sim, totals


def test_sim_trace_decomposition_equal_jax():
    (rec_j, sim_j, tot_j), (rec_t, sim_t, tot_t) = _sim_trace(J), \
        _sim_trace(T)
    assert _events(rec_t.events()) == _events(rec_j.events())
    j, t = _analysis(J, rec_j.events()), _analysis(T, rec_t.events())
    assert t == j
    assert tot_t == tot_j
    assert t["decomps"][0]["makespan"] == pytest.approx(
        sim_t.iteration_time, rel=1e-9)
    assert T.obs_critpath.check_sim_busy(t["busy"], tot_t) == []


# ------------------------------------------------- closed-loop acceptance --
def _closed_loop(m):
    """``tests/test_critpath.py``'s fixture, in package ``m``."""
    cfg = m.configs_base.ModelCfg(
        name="gpt-churn-tiny", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, rope_fraction=0.0,
        max_seq=64, norm="layernorm", act="gelu")
    batch, seq = 2, 64
    cluster = m.core_network.fat_pipe_sites(n=8, n_sites=2, seed=0)
    graph = m.models_opgraph_models.profile_opgraph(cfg, batch, seq)
    prof = graph.annotate({"tokens": (batch, seq), "labels": (batch, seq)})
    common = dict(n_micro=8, planner="joint", joint_ratio=16.0,
                  detector_threshold=20.0, calibrate_min_samples=3,
                  replan_pace_margin=0.2, **m.controller_kw)
    el = m.elastic
    probe = el.ElasticController(graph, prof, cluster, el.ChurnTrace(()),
                                 calibrate_interval=0, **common)
    t1 = probe.run(steps=1).steps[0].step_seconds
    devs = probe.schedule.stage_devices()
    model = m.core_costmodel.EdgeCostModel(graph, prof, cluster, probe.plan)
    placement = probe.schedule.placement
    boundary_s = {}
    for (a, n) in model.cross_edges(placement):
        key = (placement[a], placement[n])
        boundary_s[key] = boundary_s.get(key, 0.0) + \
            model.edge_seconds(a, n, *key)
    wan_bw = min(cluster.link(a, b).bandwidth for a, b in zip(devs, devs[1:]))
    adjacent = {d: [] for d in devs}
    for a, b in zip(devs, devs[1:]):
        adjacent[a].append((a, b))
        adjacent[b].append((a, b))
    eligible = [d for d in devs
                if all(cluster.link(i, j).bandwidth > 10.0 * wan_bw
                       for (i, j) in adjacent[d])]
    victim = max(eligible, key=lambda d: sum(boundary_s.get(p, 0.0)
                                             for p in adjacent[d]))
    t_deg = 4.0 * t1
    churn = el.ChurnTrace((el.ChurnEvent(time=t_deg, kind="slowlink",
                                         node=victim, factor=0.5),))
    kit = dict(tracer=m.obs.TraceRecorder(), flight=m.obs.FlightRecorder(),
               metrics=m.obs.MetricsRegistry(), watchdog=m.obs.Watchdog())
    ctrl = el.ElasticController(graph, prof, cluster, churn,
                                calibrate_interval=3, **kit, **common)
    res = ctrl.run(steps=14)
    replan_step = [r for r in kit["flight"].records("replan")
                   if r.cause == "calibration"][0].step
    first_deg = min(s.step for s in res.steps if s.clock > t_deg) - 1
    events = list(kit["tracer"].events())
    decomps = m.obs_critpath.analyze(events)
    window = [d for d in decomps if d.attempt[0] is not None
              and first_deg <= d.attempt[0] < replan_step]
    joint = m.core_scheduler.schedule_joint(graph, prof, cluster, 16.0)
    degraded = m.core_network.with_link_slowdowns(cluster, {victim: 0.5})
    sc = m.obs_whatif.Scenario(graph=graph, profiles=prof,
                               schedule=joint.schedule, cluster=degraded,
                               plan=joint.plan, n_micro=8)
    return dict(m=m, graph=graph, prof=prof, cluster=cluster, victim=victim,
                ctrl=ctrl, res=res, kit=kit, events=events, decomps=decomps,
                window=window, replan_step=replan_step, first_deg=first_deg,
                sc=sc, joint=joint)


@pytest.fixture(scope="module")
def loops():
    return _closed_loop(J), _closed_loop(T)


def test_closed_loop_events_and_records_equal_jax(loops):
    j, t = loops
    assert t["victim"] == j["victim"]
    assert t["replan_step"] == j["replan_step"] and \
        t["first_deg"] == j["first_deg"]
    assert _events(t["events"]) == _events(j["events"])
    assert [r.to_dict() for r in t["kit"]["flight"].records()] == \
        [r.to_dict() for r in j["kit"]["flight"].records()]
    assert t["kit"]["metrics"].snapshot() == j["kit"]["metrics"].snapshot()
    assert [dataclasses.asdict(s) for s in t["res"].steps] == \
        [dataclasses.asdict(s) for s in j["res"].steps]


def test_closed_loop_attribution_equal_jax(loops):
    j, t = loops
    a_j, a_t = _analysis(J, j["events"]), _analysis(T, t["events"])
    assert a_t == a_j
    assert [d.to_dict() for d in t["window"]] == \
        [d.to_dict() for d in j["window"]]
    cp = T.obs_critpath
    assert cp.audit(t["decomps"]) == []
    by_step = {s.step - 1: s.step_seconds for s in t["res"].steps}
    for d in t["decomps"]:
        assert d.makespan == pytest.approx(by_step[d.attempt[0]], rel=1e-9)
    rows = cp.blame(t["window"])
    assert [r.to_dict() for r in rows] == \
        [r.to_dict() for r in J.obs_critpath.blame(j["window"])]
    top = rows[0]
    assert top.kind == "wire" and t["victim"] in tuple(
        map(int, T.obs_whatif._LINK_TRACK_RE.match(top.track).groups()))
    snap = t["kit"]["metrics"].snapshot()
    totals = {k: snap[k] for k in ("sim_device_busy_seconds",
                                   "sim_link_busy_seconds",
                                   "sim_compress_busy_seconds") if k in snap}
    assert "sim_device_busy_seconds" in totals
    assert cp.check_sim_busy(a_t["busy"], totals) == \
        J.obs_critpath.check_sim_busy(a_j["busy"], totals) == []
    wd_t, wd_j = t["kit"]["watchdog"], j["kit"]["watchdog"]
    assert [r.to_dict() for r in wd_t.records] == \
        [r.to_dict() for r in wd_j.records]
    assert wd_t.first_trip().step < t["replan_step"]


def _whatif(cl):
    m, sc = cl["m"], cl["sc"]
    wi = m.obs_whatif
    rows = m.obs_critpath.blame(cl["window"])
    ranked = wi.rank(sc, wi.default_interventions(sc, rows))
    restored = sc
    for (i, j) in sorted(cl["ctrl"].link_corrections):
        restored = wi.link_speedup(i, j, 2.0).apply(restored)
    spec_truth = wi.Scenario(
        graph=cl["graph"], profiles=cl["prof"],
        schedule=cl["joint"].schedule, cluster=cl["cluster"],
        plan=cl["joint"].plan, n_micro=8).price()
    return {"baseline": sc.price(), "spec_truth": spec_truth,
            "ranked": [r.to_dict() for r in ranked],
            "node_links": wi.node_links_speedup(cl["victim"], 2.0)
            .apply(sc).price(),
            "restored": restored.price(),
            "codec_free": wi.codec_free().apply(sc).price(),
            "ratio": wi.ratio_change(32.0).apply(sc).price(),
            "drop": wi.drop_device(cl["victim"]).apply(sc).price(),
            "drop_dense": wi.drop_device(cl["victim"], ratio=1.0)
            .apply(sc).price(),
            "corrections": sorted(cl["ctrl"].link_corrections.items())}


def test_whatif_equal_jax(loops):
    j, t = loops
    w_j, w_t = _whatif(j), _whatif(t)
    assert w_t == w_j
    window_secs = [s.step_seconds for s in t["res"].steps
                   if t["first_deg"] <= s.step - 1 < t["replan_step"]]
    assert w_t["baseline"] == pytest.approx(window_secs[0], rel=1e-9)
    top_link = next(r for r in w_t["ranked"] if r["name"].startswith("link "))
    a, b = top_link["name"].split()[1].split("->")
    fitted = dict(w_t["corrections"])
    assert (int(a), int(b)) in fitted and top_link["delta_seconds"] > 0
    for key in ("node_links", "restored"):
        assert w_t[key] == pytest.approx(w_t["spec_truth"], rel=0.05)


def test_report_equal_jax(loops):
    j, t = loops
    flight_j = [r.to_dict() for r in j["kit"]["flight"].records()]
    flight_t = [r.to_dict() for r in t["kit"]["flight"].records()]
    for width in (80, 120):
        text_t = T.obs_report.build_report(t["events"], flight_t, width)
        assert text_t == J.obs_report.build_report(j["events"], flight_j,
                                                   width)
    for section in ("timeline", "comm/compute overlap", "straggler heatmap",
                    "critical path", "top interventions", "decision log"):
        assert f"== {section} ==" in text_t
    assert "watchdog" in text_t


# ------------------------------------------------------------------ CLIs --
def _overflowed(m):
    rec = m.obs.TraceRecorder(capacity=4)
    for i in range(8):
        rec.span(m.obs_trace.CAT_FWD, f"F0.mb{i}", "dev0", float(i),
                 float(i) + 0.5, args={"step": 0, "epoch": 0, "mb": i})
    return rec


def _run_cli(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cli", ["critpath", "report"])
def test_cli_refuses_truncated_equal_jax(cli, tmp_path):
    path = str(tmp_path / "TRACE_t.jsonl")
    T.obs_export.write_jsonl(_overflowed(T), path)
    got = {}
    for name, m in (("jax", J), ("torch", T)):
        main = getattr(m, f"obs_{cli}").main
        got[name] = (_run_cli(main, [path]),
                     _run_cli(main, [path, "--allow-truncated"]))
    assert got["torch"] == got["jax"]
    refused, allowed = got["torch"]
    assert refused[0] == 2 and "dropped" in refused[2]
    assert allowed[0] == 0


def test_critpath_cli_busy_gate_equal_jax(tmp_path):
    rec, _, good = _sim_trace(T)
    trace_path = str(tmp_path / "TRACE_s.jsonl")
    T.obs_export.write_jsonl(rec, trace_path)
    paths = {}
    for name, totals in (("good", good), ("bad", dict(
            good, sim_link_busy_seconds=good["sim_link_busy_seconds"] * 2))):
        paths[name] = str(tmp_path / f"METRICS_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(totals, f)
    for name, rc in (("good", 0), ("bad", 1)):
        out = {}
        for side, m in (("jax", J), ("torch", T)):
            art = str(tmp_path / f"CRITPATH_{side}_{name}.json")
            r = _run_cli(m.obs_critpath.main,
                         [trace_path, "--expect-busy", paths[name],
                          "--json", art])
            with open(art) as f:
                out[side] = (r[0], r[1].replace(art, "ART"), r[2],
                             json.load(f))
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == rc


@pytest.mark.parametrize("case,rc", [("good", 0), ("overlap", 1)])
def test_export_check_order_equal_jax(case, rc, tmp_path):
    if case == "good":
        rec = _sim_trace(T)[0]
    else:
        rec = T.obs.TraceRecorder()
        rec.span("link.transfer", "Fxfer.mb0", "link 0->1", 0.0, 2.0)
        rec.span("link.transfer", "Fxfer.mb1", "link 0->1", 1.0, 3.0)
    for suffix, write in ((".jsonl", T.obs_export.write_jsonl),
                          (".json", T.obs_export.write_chrome_trace)):
        path = str(tmp_path / f"TRACE_{case}{suffix}")
        write(rec, path)
        for argv in ([path, "--check-order"],
                     [path, "--validate", "--check-order"]):
            got_t = _run_cli(T.obs_export.main, argv)
            assert got_t == _run_cli(J.obs_export.main, argv)
            assert got_t[0] == rc
            if rc == 0:
                assert "happens-before ok" in got_t[1]
            else:
                assert "overlap @ link 0->1" in got_t[2]
        # schema validation alone does not order-check
        assert _run_cli(T.obs_export.main, [path, "--validate"])[0] == 0
