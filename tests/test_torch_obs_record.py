"""The port's flight recorder, telemetry bus and watchdog against the JAX
package's: the same inputs give EQUAL records (all three are stdlib code
fed by the framework-free simulator), mirroring the recorder, bus and
watchdog cases of ``tests/test_obs.py`` and ``tests/test_critpath.py``."""
import dataclasses
import types

import pytest

pytest.importorskip("torch")

import repro.core.executor as j_exec  # noqa: E402
import repro.elastic as j_el  # noqa: E402
import repro.obs as j_obs  # noqa: E402
import repro.obs.record as j_record  # noqa: E402
import repro_torch.core.executor as t_exec  # noqa: E402
import repro_torch.elastic as t_el  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
import repro_torch.obs.record as t_record  # noqa: E402
from test_torch_elastic import J as JE, T as TE, _fat_pipe, _fat_pipe_victim, _probe, _run  # noqa: E402


def _side(obs, record, ex, el, elastic_side):
    return types.SimpleNamespace(obs=obs, record=record, ex=ex, el=el,
                                 e=elastic_side)


J = _side(j_obs, j_record, j_exec, j_el, JE)
T = _side(t_obs, t_record, t_exec, t_el, TE)


def _step(ex, node, step, seconds):
    return ex.StepTiming(node=node, stage=0, micro_batch=0, backward=False,
                         compute_seconds=seconds, comm_seconds=0.0, step=step)


def _link(ex, step, nbytes, seconds):
    return ex.LinkTiming(src=0, dst=1, nbytes=nbytes, seconds=seconds,
                         step=step)


# ---------------------------------------------------------------- watchdog
def wd_warmup_then_trip(m):
    wd = m.obs.Watchdog()
    for i in range(8):
        wd.observe_step(i, float(i), 1.0)
    assert wd.records == []
    wd.observe_step(8, 8.0, 2.0)
    assert {"ewma", "mad"} <= {r.rule for r in wd.records}
    assert wd.first_trip().signal == "step_seconds"
    return wd


def wd_no_trip_during_warmup(m):
    wd = m.obs.Watchdog(warmup=3)
    wd.observe_step(0, 0.0, 1.0)
    wd.observe_step(1, 1.0, 50.0)
    assert wd.records == []
    return wd


def wd_holdoff_dedupes(m):
    wd = m.obs.Watchdog(holdoff=8)
    for i in range(8):
        wd.observe_step(i, float(i), 1.0)
    for i in range(8, 13):
        wd.observe_step(i, float(i), 2.0)
    assert len([r for r in wd.records if r.rule == "ewma"]) == 1
    return wd


def wd_step_slo_p99(m):
    wd = m.obs.Watchdog(step_slo_p99=1.5)
    for i in range(10):
        wd.observe_step(i, float(i), 1.0 if i < 5 else 2.0)
    slo = wd.first_trip(rule="slo")
    assert slo is not None and slo.signal == "step_seconds_p99"
    return wd


def wd_tokens_floor(m):
    wd = m.obs.Watchdog(tokens_floor=10.0)
    for i in range(3):
        wd.observe_tokens(i, float(i), 20.0)
    wd.observe_tokens(3, 3.0, 5.0)
    assert wd.first_trip(rule="slo").signal == "tokens_per_s"
    return wd


def wd_bus_sink_protocol(m):
    wd = m.obs.Watchdog()
    for step in range(9):
        wd.record(_step(m.ex, 3, step, 1.0 if step < 8 else 2.0))
        wd.record_link(_link(m.ex, step, 100.0, 1e-3 if step < 8 else 2e-3))
    assert {"stage3_seconds", "link 0->1"} <= {r.signal for r in wd.records}
    return wd


def wd_link_normalizes_per_byte(m):
    wd = m.obs.Watchdog()
    for step in range(9):
        nb = 100.0 if step < 8 else 200.0
        wd.record_link(_link(m.ex, step, nb, nb * 1e-5))
    assert wd.records == []
    return wd


WATCHDOG = {f.__name__[3:]: f for f in (
    wd_warmup_then_trip, wd_no_trip_during_warmup, wd_holdoff_dedupes,
    wd_step_slo_p99, wd_tokens_floor, wd_bus_sink_protocol,
    wd_link_normalizes_per_byte)}


@pytest.mark.parametrize("name", sorted(WATCHDOG))
def test_watchdog_records_equal_jax(name):
    def summary(m):
        wd = WATCHDOG[name](m)
        trip = wd.first_trip()
        return ([r.to_dict() for r in wd.records],
                trip.to_dict() if trip is not None else None)
    assert summary(T) == summary(J)


# --------------------------------------------------------------- the bus --
def test_telemetry_bus_parity_and_metrics_fan_out():
    """A TelemetryLog fed through the bus equals one fed directly, and the
    metrics sink's snapshot equals the JAX package's."""
    out = {}
    for name, m in (("jax", J), ("torch", T)):
        g, prof, cluster = _fat_pipe(m.e, n_layers=6)
        sch = m.e.schedule_opfence(g, prof, cluster)
        sink = m.ex.TelemetrySink()
        m.e.simulate_iteration(g, prof, sch, cluster, n_micro=2,
                               telemetry=sink)
        direct, bused = m.el.TelemetryLog(window=5), m.el.TelemetryLog(window=5)
        metrics = m.obs.MetricsRegistry()
        bus = m.obs.TelemetryBus([bused])
        bus.subscribe(m.obs.MetricsTelemetrySink(metrics))
        for step in range(4):
            direct.record_step(sink.samples, step)
            direct.record_link_step(sink.link_samples, step)
            bus.record_step(sink.samples, step)
            bus.record_link_step(sink.link_samples, step)
        assert bused.node_step_times() == direct.node_step_times()
        assert bused.link_samples(min_steps=3) == \
            direct.link_samples(min_steps=3)
        assert bused.n_samples == direct.n_samples
        assert bused.latest_step() == direct.latest_step() == 3
        out[name] = (bused.node_step_times(), bused.link_samples(3),
                     metrics.snapshot())
    assert out["torch"] == out["jax"]


def test_links_to_str_and_record_dicts():
    for m in (J, T):
        assert m.record.links_to_str({(0, 1): 2.0, (3, 2): 1.0}) == \
            {"0->1": 2.0, "3->2": 1.0}
    score = dict(name="keep", pace=1.5, migration_bytes=0.0,
                 migration_seconds=0.0, score=150.0, winner=True)
    recs = []
    for m in (J, T):
        r = m.record
        recs.append([
            r.ReplanRecord(step=3, clock=2.5, cause="failure", reason="x",
                           dead=[4], joined=[],
                           candidates=[r.CandidateScore(**score), score],
                           winner="keep").to_dict(),
            r.CalibrationRecord(step=1, clock=1.0, window={"0->1": 3},
                                fitted={"0->1": 2.0},
                                verdicts={"0->1": "adopted"},
                                installed={"0->1": 2.0}, repriced=True,
                                installed_pace=1.0, calibrated_pace=2.0,
                                diverged=True).to_dict(),
            r.EpochFlightRecord(step=0, clock=0.0, epoch=0, cause="initial",
                                stage_devices=[1, 2], n_moves=0,
                                moved_bytes=0.0, migrate_seconds=0.0,
                                refill_seconds=0.0,
                                rollback_steps=0).to_dict(),
            r.DetectorRecord(step=5, clock=4.0, node=2, severity=3.0,
                             believed_factor=1 / 3).to_dict(),
            r.RouteRecord(step=1, clock=0.5, session="s0", cause="admit",
                          dead=[], old_chain=[], chain=[0, 1],
                          replay_tokens=0, kv_ship_bytes=0).to_dict(),
            r.WatchdogRecord(step=2, clock=1.0, rule="slo",
                             signal="tokens_per_s", value=5.0,
                             reference=10.0, severity=0.5).to_dict()])
    assert recs[0] == recs[1]


# ------------------------------------------ the instrumented controller --
@pytest.fixture(scope="module")
def slowlink_runs():
    """The closed-loop slowlink scenario through both packages, fully
    instrumented (tracer, flight recorder, metrics, watchdog), and once
    bare through the port."""
    out = {}
    for name, m in (("jax", J), ("torch", T)):
        g, prof, cluster = _fat_pipe(m.e)
        common = dict(n_micro=2, planner="joint", joint_ratio=64.0,
                      detector_threshold=20.0, calibrate_min_samples=3,
                      replan_pace_margin=0.2, calibrate_interval=3)
        probe, t1 = _probe(m.e, g, prof, cluster, **{
            k: v for k, v in common.items() if k != "n_micro"})
        victim = _fat_pipe_victim(m.e, probe, cluster)
        churn = m.el.ChurnTrace((m.el.ChurnEvent(
            time=4.0 * t1, kind="slowlink", node=victim, factor=0.5),))
        kit = dict(tracer=m.obs.TraceRecorder(),
                   flight=m.obs.FlightRecorder(),
                   metrics=m.obs.MetricsRegistry(),
                   watchdog=m.obs.Watchdog())
        ctrl = m.e.EC(g, prof, cluster, churn, **kit, **common)
        res = ctrl.run(steps=30)
        out[name] = dict(ctrl=ctrl, res=res, **kit)
        if m is T:
            bare = m.e.EC(g, prof, cluster, churn, **common)
            out["bare"] = dict(ctrl=bare, res=bare.run(steps=30))
    return out


def test_flight_log_and_metrics_equal_jax(slowlink_runs):
    t, j = slowlink_runs["torch"], slowlink_runs["jax"]
    assert _run(t["res"]) == _run(j["res"])
    assert t["flight"].to_dicts() == j["flight"].to_dicts()
    assert t["metrics"].snapshot() == j["metrics"].snapshot()
    assert [r.to_dict() for r in t["watchdog"].records] == \
        [r.to_dict() for r in j["watchdog"].records]
    cals = t["flight"].records("calibration")
    assert any("adopted" in c.verdicts.values() for c in cals)
    assert any(c.diverged for c in cals)
    rp = [r for r in t["flight"].records("replan")
          if r.cause == "calibration"][0]
    assert "keep" in [c.name for c in rp.candidates]
    assert len([c for c in rp.candidates if c.winner]) == 1
    first = t["watchdog"].first_trip()
    assert first is not None and first.step < rp.step
    snap = t["metrics"].snapshot()
    assert snap.get("replan_count{cause=initial}") == 1
    assert snap.get("calibration_fits", 0) >= 1
    assert any(k.startswith("watchdog_trips") and v > 0
               for k, v in snap.items())


def test_controller_trace_equals_jax(slowlink_runs):
    def events(run):
        return [dataclasses.asdict(e) for e in run["tracer"].events()]
    t = events(slowlink_runs["torch"])
    assert t == events(slowlink_runs["jax"])
    assert any(e["cat"] == "controller" and e["name"].startswith("replan:")
               for e in t)


def test_tracing_does_not_change_sim_metrics(slowlink_runs):
    res, bare = slowlink_runs["torch"]["res"], slowlink_runs["bare"]["res"]
    assert _run(res) == _run(bare)
    assert slowlink_runs["torch"]["ctrl"].link_corrections == \
        slowlink_runs["bare"]["ctrl"].link_corrections


def test_flight_log_jsonl_round_trip(slowlink_runs, tmp_path):
    flight = slowlink_runs["torch"]["flight"]
    path = str(tmp_path / "flight.jsonl")
    flight.to_jsonl(path)
    import json
    assert t_record.read_jsonl(path) == \
        [json.loads(json.dumps(d, sort_keys=True)) for d in flight.to_dicts()]
    assert len(flight) == len(flight.records())
    assert all(dataclasses.is_dataclass(r) for r in flight.records("epoch"))
