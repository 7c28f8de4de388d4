"""The port's swarm serving (``repro_torch.serving``, ``obs.export``,
``launch.serve``) against the JAX package's, on the CPU.

* The framework-free parts — cost model, planner, request trace, queue,
  router, failure derivation, trace export — are held exactly equal.
* A chain of stage executors is bit-identical to the port's own monolithic
  ``prefill`` / ``decode_step`` at 2 and 3 stages, dense and moe, and
  within rtol 1e-5, atol 1e-6 of the JAX package's logits on the same
  weights (JAX's own 3-stage chain is not bit-exact against its
  monolithic model; ROADMAP Queue 3).
* ``ServingRuntime`` with and without churn gives JAX's tokens, simulated
  report, flight records, spans and counters, exactly.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.core import network as j_net  # noqa: E402
from repro.elastic.membership import ChurnTrace as JChurnTrace  # noqa: E402
from repro.elastic.membership import MembershipView as JView  # noqa: E402
from repro.models import causal_lm as j_lm  # noqa: E402
from repro import obs as j_obs  # noqa: E402
from repro import serving as j_srv  # noqa: E402
from repro_torch.checkpoint import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.core import network as t_net  # noqa: E402
from repro_torch.elastic.membership import ChurnTrace as TChurnTrace  # noqa: E402
from repro_torch.elastic.membership import MembershipView as TView  # noqa: E402
from repro_torch.models import causal_lm as t_lm  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch import serving as t_srv  # noqa: E402
from test_torch_models import ATOL, CPU, RTOL, _np_tree  # noqa: E402

DENSE = dict(name="serve-dense", family="dense", n_layers=5, d_model=48,
             n_heads=4, n_kv_heads=2, d_ff=96, vocab=89)
MOE = dict(name="serve-moe", family="moe", n_layers=4, d_model=48,
           n_heads=4, n_kv_heads=2, d_ff=64, vocab=89, n_experts=4, top_k=2,
           tie_embeddings=True)
GPT = dict(name="serve-gpt", family="dense", n_layers=4, d_model=32,
           n_heads=4, n_kv_heads=4, d_ff=64, vocab=97, rope_fraction=0.0,
           max_seq=64, norm="layernorm", act="gelu", qkv_bias=True,
           vocab_pad_to=32)
CFGS = {"dense": DENSE, "moe": MOE, "gpt": GPT}


def _cfgs(name, **kw):
    return JModelCfg(**{**CFGS[name], **kw}), TModelCfg(**{**CFGS[name], **kw})


def _weights(name, seed=0):
    cj, ct = _cfgs(name)
    pj = j_lm.init(cj, jax.random.PRNGKey(seed))
    return cj, ct, pj, from_numpy_tree(_np_tree(pj), CPU)


def _fields(obj):
    """A dataclass (of either package) as plain data, nested specs too."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


# ---------------------------------------------------------- stage split --
@pytest.mark.parametrize("name", ["dense", "moe", "gpt"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_split_and_stage_params_match_jax(name, n):
    cj, ct, pj, pt = _weights(name)
    sj, st = j_srv.split_stages(cj, n), t_srv.split_stages(ct, n)
    assert [_fields(s) for s in st] == [_fields(s) for s in sj]
    assert [str(s) for s in st] == [str(s) for s in sj]
    for a, b in zip(st, sj):
        spt = t_srv.stage_params(ct, pt, a)
        spj = _np_tree(j_srv.stage_params(cj, pj, b))
        got = to_numpy_tree(spt)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(spj)
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(spj)):
            np.testing.assert_array_equal(x, y)
        # the block slice is a view of the stacked leaves, not a copy
        w = spt["blocks"]["attn"]["wq"]["w"]
        assert w.untyped_storage().data_ptr() == \
            pt["blocks"]["attn"]["wq"]["w"].untyped_storage().data_ptr()


@pytest.mark.parametrize("make", [
    lambda M: M(name="h", family="hybrid", n_layers=4, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab=89, attn_every=2),
    lambda M: M(**{**DENSE, "n_prefix": 2, "d_frontend": 8}),
])
def test_check_shardable_rejects_like_jax(make):
    with pytest.raises(ValueError) as ej:
        j_srv.check_shardable(make(JModelCfg))
    with pytest.raises(ValueError) as et:
        t_srv.check_shardable(make(TModelCfg))
    assert str(et.value) == str(ej.value)
    for n in (0, 6):
        with pytest.raises(ValueError, match="n_stages"):
            t_srv.split_stages(TModelCfg(**DENSE), n)


# ---------------------------------------------------------------- costs --
def _clusters(n):
    return [(j_net.homogeneous_lan(n), t_net.homogeneous_lan(n)),
            (j_net.geo_random(n, seed=2), t_net.geo_random(n, seed=2))]


@pytest.mark.parametrize("name,kw", [
    ("dense", {}), ("dense", {"dtype": "bfloat16"}), ("gpt", {}),
    ("moe", {"n_shared_experts": 2, "qkv_bias": True}),
])
def test_cost_model_equals_jax_exactly(name, kw):
    cj, ct = _cfgs(name, **kw)
    corr = {(0, 1): 2.5, (3, 2): 0.7}
    for clj, clt in _clusters(5):
        mj = j_srv.ServingCostModel(cj, clj, corr)
        mt = t_srv.ServingCostModel(ct, clt, corr)
        assert mt.act_itemsize == mj.act_itemsize
        assert mt.act_bytes_per_token() == mj.act_bytes_per_token()
        for n in (1, 2, 3):
            for a, b in zip(t_srv.split_stages(ct, n),
                            j_srv.split_stages(cj, n)):
                assert mt.stage_in_bytes_per_token(a) == \
                    mj.stage_in_bytes_per_token(b)
                assert mt.kv_bytes_per_token(a) == mj.kv_bytes_per_token(b)
                assert mt.kv_bytes(a, 33) == mj.kv_bytes(b, 33)
                assert mt.stage_param_bytes(a) == mj.stage_param_bytes(b)
                assert mt.stage_decode_flops(a, 64) == \
                    mj.stage_decode_flops(b, 64)
                assert _fields(mt.stage_costs(a, 17)) == \
                    _fields(mj.stage_costs(b, 17))
                for dev in range(5):
                    assert mt.stage_seconds(dev, a, 64) == \
                        mj.stage_seconds(dev, b, 64)
                    for src in range(5):
                        assert mt.hop_seconds(src, dev, a) == \
                            mj.hop_seconds(src, dev, b)
        for src in range(5):
            for dst in range(5):
                assert mt.link_seconds(src, dst, 4096) == \
                    mj.link_seconds(src, dst, 4096)
        lifted = t_srv.ServingCostModel.from_cost_model(
            ct, types.SimpleNamespace(cluster=clt, link_corrections=corr))
        assert lifted.link_corrections == corr and lifted.cluster is clt
        assert mt.with_link_corrections({}).link_seconds(0, 1, 4096) == \
            mj.with_link_corrections({}).link_seconds(0, 1, 4096)


@pytest.mark.parametrize("name", ["dense", "moe", "gpt"])
def test_stage_param_bytes_equal_the_hosted_subtree(name):
    _, ct, _, pt = _weights(name)
    costs = t_srv.ServingCostModel(ct, t_net.homogeneous_lan(2))
    for spec in t_srv.split_stages(ct, 2):
        hosted = t_srv.stage_params(ct, pt, spec)
        real = sum(a.numel() * a.element_size()
                   for a in jax.tree_util.tree_leaves(hosted))
        assert costs.stage_param_bytes(spec) == real


# ----------------------------------------------------------------- plan --
@pytest.mark.parametrize("arch,n_dev,n_stages,cache_len,max_batch", [
    ("gpt2-xl", 8, 3, 64, 4),           # the card's serve phase
    ("llama3-8b", 8, 2, 64, 4),         # the JAX serving benchmark's geo
    ("gpt2-xl", 5, 2, 2048, 64),        # memory-infeasible
])
def test_plan_serving_equals_jax(arch, n_dev, n_stages, cache_len,
                                 max_batch):
    from repro.configs import resolve as j_resolve
    from repro_torch.configs import resolve as t_resolve
    cj, ct = j_resolve(arch).full, t_resolve(arch).full
    mj = j_srv.ServingCostModel(cj, j_net.geo_random(n_dev, seed=0))
    mt = t_srv.ServingCostModel(ct, t_net.geo_random(n_dev, seed=0))
    args = (list(range(n_dev)),)
    kw = dict(n_stages=n_stages, cache_len=cache_len, max_batch=max_batch)
    try:
        pj = j_srv.plan_serving(cj, mj, *args, **kw)
    except j_srv.ServingPlanError as e:
        with pytest.raises(t_srv.ServingPlanError) as et:
            t_srv.plan_serving(ct, mt, *args, **kw)
        assert str(et.value) == str(e)
        return
    pt = t_srv.plan_serving(ct, mt, *args, **kw)
    assert pt.describe() == pj.describe()
    assert pt.replicas == pj.replicas and pt.devices() == pj.devices()
    assert [pt.stage_of(d) for d in range(n_dev)] == \
        [pj.stage_of(d) for d in range(n_dev)]


def test_plan_serving_rejects_like_jax():
    cj, ct = _cfgs("dense")
    for alive in ([], [0]):
        with pytest.raises(j_srv.ServingPlanError) as ej:
            j_srv.plan_serving(cj, j_srv.ServingCostModel(
                cj, j_net.homogeneous_lan(4)), alive, 2, 32)
        with pytest.raises(t_srv.ServingPlanError) as et:
            t_srv.plan_serving(ct, t_srv.ServingCostModel(
                ct, t_net.homogeneous_lan(4)), alive, 2, 32)
        assert str(et.value) == str(ej.value)


# ------------------------------------------------- traffic, queue, router --
@pytest.mark.parametrize("args", [
    (6, 50.0, 97, (2, 5), (3, 7), 11), (10, 100.0, 512, (4, 12), (16, 32), 0),
    (0, 1.0, 10, (1, 2), (1, 2), 0)])
def test_poisson_trace_equals_jax(args):
    n, rate, vocab, pl, gl, seed = args
    a = j_srv.poisson_trace(n, rate, vocab, pl, gl, seed)
    b = t_srv.poisson_trace(n, rate, vocab, pl, gl, seed)
    assert [_fields(r) for r in b] == [_fields(r) for r in a]
    with pytest.raises(ValueError, match="rate"):
        t_srv.poisson_trace(2, 0.0, 10)


def test_request_queue_equals_jax():
    spec = [("b", 2.0, (1, 2), 3), ("a", 0.5, (3,), 2), ("c", 0.5, (4,), 1)]
    qj = j_srv.RequestQueue([j_srv.Request(*r) for r in spec])
    qt = t_srv.RequestQueue([t_srv.Request(*r) for r in spec])
    for now in (0.1, 0.5, 0.5, 1.0, 2.0, 2.0):
        assert (qt.due(now), qt.next_arrival(), len(qt), qt.empty) == \
            (qj.due(now), qj.next_arrival(), len(qj), qj.empty)
        if qj.due(now):
            assert qt.pop(now).rid == qj.pop(now).rid
        else:
            with pytest.raises(RuntimeError):
                qt.pop(now)
    assert qt.n_admitted == qj.n_admitted == 3 and qt.peek() is None


def _plans(n_dev=6, n_stages=2, max_batch=2, geo=True):
    cj, ct = _cfgs("dense")
    clj = j_net.geo_random(n_dev, seed=1) if geo \
        else j_net.homogeneous_lan(n_dev)
    clt = t_net.geo_random(n_dev, seed=1) if geo \
        else t_net.homogeneous_lan(n_dev)
    kw = dict(n_stages=n_stages, cache_len=32, max_batch=max_batch)
    return (j_srv.plan_serving(cj, j_srv.ServingCostModel(cj, clj),
                               list(range(n_dev)), **kw),
            t_srv.plan_serving(ct, t_srv.ServingCostModel(ct, clt),
                               list(range(n_dev)), **kw))


def test_session_router_equals_jax():
    """The same admissions, releases, re-routes and their flight records."""
    pj, pt = _plans(n_dev=7, n_stages=3, max_batch=2)
    fj, ft = j_obs.FlightRecorder(), t_obs.FlightRecorder()
    rj = j_srv.SessionRouter(pj, flight=fj)
    rt = t_srv.SessionRouter(pt, flight=ft)
    alive = list(range(7))
    sess_j, sess_t = [], []
    for i in range(5):
        assert rt.has_capacity(alive) == rj.has_capacity(alive)
        if not rj.has_capacity(alive):
            break
        cj, ct = rj.pick_chain(alive), rt.pick_chain(alive)
        assert ct == cj
        rj.acquire(cj)
        rt.acquire(ct)
        req = (f"r{i}", 0.0, (1, 2, 3), 4)
        sj = j_srv.Session(request=j_srv.Request(*req), chain=list(cj),
                           admitted_at=0.0, pos=3 + i)
        st = t_srv.Session(request=t_srv.Request(*req), chain=list(ct),
                           admitted_at=0.0, pos=3 + i)
        rj.log_route(sj, "admit", list(cj), [], 0, 0.1 * i, i)
        rt.log_route(st, "admit", list(ct), [], 0, 0.1 * i, i)
        sess_j.append(sj)
        sess_t.append(st)
        assert rt.load == rj.load
    rj.release(sess_j[0].chain)
    rt.release(sess_t[0].chain)
    dead = [sess_j[1].chain[1]]
    alive = [d for d in alive if d not in dead]
    for sj, st in zip(sess_j[1:], sess_t[1:]):
        old = list(sj.chain)
        got = rt.reroute(st, dead, alive)
        assert got == rj.reroute(sj, dead, alive)
        assert (st.chain, st.n_reroutes) == (sj.chain, sj.n_reroutes)
        rj.log_route(sj, "reroute", old, dead, 7, 1.0, 9)
        rt.log_route(st, "reroute", old, dead, 7, 1.0, 9)
    assert rt.load == rj.load
    assert [r.to_dict() for r in ft.records()] == \
        [r.to_dict() for r in fj.records()]
    dark = [d for d in range(7) if d not in pj.replicas[0]]
    with pytest.raises(j_srv.NoChainError) as ej:
        rj.pick_chain(dark)
    with pytest.raises(t_srv.NoChainError) as et:
        rt.pick_chain(dark)
    assert str(et.value) == str(ej.value)


# ----------------------------------------------------- the staged chain --
@pytest.mark.parametrize("name", ["dense", "moe", "gpt"])
@pytest.mark.parametrize("n_stages", [2, 3])
def test_stage_chain_bit_exact_and_close_to_jax(name, n_stages):
    """Chained stage prefill + 4 decode steps == the port's monolithic
    prefill + decode_step, bit for bit; both within tolerance of JAX's
    monolithic logits (teacher-forced on the port's greedy tokens)."""
    cj, ct, pj, pt = _weights(name)
    cache_len = 24
    prompt = np.random.default_rng(1).integers(
        0, ct.vocab, (1, 6)).astype(np.int32)
    ref, cache = t_lm.prefill(ct, pt, torch.from_numpy(prompt),
                              cache_len=cache_len)
    jref, jcache = j_lm.prefill(cj, pj, prompt, cache_len=cache_len)
    execs = [t_srv.StageExecutor(ct, s, t_srv.stage_params(ct, pt, s),
                                 cache_len, device="cpu")
             for s in t_srv.split_stages(ct, n_stages)]
    x, kvs = torch.from_numpy(prompt), []
    for ex in execs:
        x, kv = ex.prefill(x)
        kvs.append(kv)
    for step in range(5):
        assert torch.equal(x, ref), f"step {step}"
        np.testing.assert_allclose(ref.numpy(), np.asarray(jref),
                                   rtol=RTOL, atol=ATOL)
        if step == 4:
            break
        tok = torch.argmax(ref[:, -1, :], dim=-1)[:, None]
        ref, cache = t_lm.decode_step(ct, pt, cache, tok)
        jref, jcache = j_lm.decode_step(cj, pj, jcache, tok.numpy())
        x = tok
        for i, ex in enumerate(execs):
            x, kvs[i] = ex.decode(x, kvs[i], 6 + step)
    with pytest.raises(ValueError, match="outside the cache"):
        execs[0].decode(tok, kvs[0], cache_len)


# -------------------------------------------------------------- runtime --
def _run(pkg, cfg, params, plan, requests, churn, n_dev, **kw):
    """One runtime leg with every observer on; returns what it emitted."""
    srv, obs = (j_srv, j_obs) if pkg == "jax" else (t_srv, t_obs)
    view = (JView if pkg == "jax" else TView)(n_dev, churn, lease_s=1e-5)
    tr, fl, mx = obs.TraceRecorder(), obs.FlightRecorder(), \
        obs.MetricsRegistry()
    tokens = {}
    if pkg == "torch":
        kw["device"] = "cpu"
    rt = srv.ServingRuntime(cfg, params, plan, view, trace=tr, flight=fl,
                            metrics=mx, on_token=lambda rid, t, now:
                                tokens.setdefault(rid, []).append(t), **kw)
    report = rt.run(list(requests))
    spans = [(e.clock, e.phase, e.cat, e.name, e.track, e.ts, e.dur, e.args)
             for e in tr.events()]
    return (_fields(report), tokens, [r.to_dict() for r in fl.records()],
            spans, mx.snapshot())


@pytest.mark.parametrize("name,n_dev,n_stages,max_batch,n_req,gen", [
    ("dense", 6, 2, 3, 5, (12, 18)),
    ("moe", 7, 3, 2, 3, (8, 10)),
    ("gpt", 2, 2, 1, 3, (3, 5)),          # one slot: admit-on-slot-free
])
def test_runtime_with_and_without_churn_equals_jax(name, n_dev, n_stages,
                                                   max_batch, n_req, gen):
    cj, ct, pj, pt = _weights(name)
    kw = dict(n_stages=n_stages, cache_len=64, max_batch=max_batch)
    plan_j = j_srv.plan_serving(cj, j_srv.ServingCostModel(
        cj, j_net.homogeneous_lan(n_dev)), list(range(n_dev)), **kw)
    plan_t = t_srv.plan_serving(ct, t_srv.ServingCostModel(
        ct, t_net.homogeneous_lan(n_dev)), list(range(n_dev)), **kw)
    reqs = j_srv.poisson_trace(n_req, 200.0, cj.vocab, gen_len=gen, seed=3)
    reqs_t = t_srv.poisson_trace(n_req, 200.0, ct.vocab, gen_len=gen, seed=3)
    base_j = _run("jax", cj, pj, plan_j, reqs, JChurnTrace(()), n_dev)
    base_t = _run("torch", ct, pt, plan_t, reqs_t, TChurnTrace(()), n_dev)
    assert base_t == base_j
    if max_batch == 1:
        assert base_t[0]["all_completed"] and base_t[0]["rounds"] > \
            max(len(t) for t in base_t[1].values())
        return
    vj, atj, rj, tj = j_srv.derive_midsession_failure(cj, pj, plan_j, reqs,
                                                      n_dev)
    vt, att, rt_, tt = t_srv.derive_midsession_failure(ct, pt, plan_t,
                                                       reqs_t, n_dev,
                                                       device="cpu")
    assert (vt, att, _fields(rt_), tt) == (vj, atj, _fields(rj), tj)
    churn_j = _run("jax", cj, pj, plan_j, reqs,
                   j_srv.churn_trace_for(vj, atj), n_dev)
    churn_t = _run("torch", ct, pt, plan_t, reqs_t,
                   t_srv.churn_trace_for(vt, att), n_dev)
    assert churn_t == churn_j
    report, tokens, flight, spans, _ = churn_t
    assert report["all_completed"] and report["n_reroutes"] >= 1
    assert tokens == base_t[1], "KV replay is not bit-exact"
    assert any(r["cause"] == "reroute" and r["replay_tokens"] > 0
               for r in flight)
    assert any(s[2] == "serve.replay" for s in spans)


# --------------------------------------------------------------- export --
def _record(obs):
    tr = obs.TraceRecorder(capacity=6)
    tr.span("fwd", "decode.r1", "dev0", 0.0, 0.25, args={"step": 1})
    tr.span("transfer", "hop.r1", "link 0->1", 0.1, 0.3, args={"bytes": 96})
    tr.instant("controller", "reroute.r0", "controller", t=0.2,
               args={"dead": [1]})
    tr.span("serve.replay", "replay.r0.s1", "dev2", 0.2, 0.4)
    tr.instant("controller", "mark", "host", t=0.5)
    tr.span("fwd", "decode.r2", "dev0", 0.5, 0.75, clock="wall")
    tr.span("fwd", "decode.r3", "dev1", 0.75, 0.8)    # drops the first
    return tr


def test_export_equals_jax(tmp_path):
    trj, trt = _record(j_obs), _record(t_obs)
    assert t_obs.to_trace_events(trt) == j_obs.to_trace_events(trj)
    for fn in ("write_jsonl", "write_chrome_trace"):
        pj, pt = tmp_path / f"j_{fn}", tmp_path / f"t_{fn}"
        mj, mt = j_obs.MetricsRegistry(), t_obs.MetricsRegistry()
        nj = getattr(j_obs, fn)(trj, str(pj), metrics=mj)
        nt = getattr(t_obs, fn)(trt, str(pt), metrics=mt)
        assert nt == nj and pt.read_text() == pj.read_text()
        assert mt.snapshot() == mj.snapshot() == {"trace_dropped_events": 1}
    rows = t_obs.read_jsonl(str(tmp_path / "t_write_jsonl"))
    assert rows == j_obs.read_jsonl(str(tmp_path / "j_write_jsonl"))
    assert t_obs.read_header(rows) == j_obs.read_header(rows)
    back = t_obs.events_from_dicts(rows)
    assert [dataclasses.astuple(e) for e in back] == \
        [dataclasses.astuple(e) for e in trt.events()]
    events = t_obs.to_trace_events(back)
    assert t_obs.validate_trace_events(events) == []
    bad = [{"ph": "X", "name": "", "pid": "1", "tid": 1, "ts": -1},
           {"ph": "M", "name": "m", "pid": 1, "tid": 1, "ts": 0},
           {"ph": "Q"}, 3]
    assert t_obs.validate_trace_events(bad) == \
        j_obs.validate_trace_events(bad)
    assert t_obs.validate_trace_events([]) == ["empty trace: no events"]


def test_export_cli_validates(tmp_path, capsys):
    from repro_torch.obs import export
    good = tmp_path / "t.json"
    export.write_chrome_trace(_record(t_obs), str(good))
    assert export.main([str(good), "--validate"]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    assert export.main([str(bad), "--validate"]) == 1
    assert "INVALID" in capsys.readouterr().err


# ------------------------------------------------------------- launcher --
def test_launcher_churn_trace_and_flight_equal_jax(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --size smoke
    --churn --trace --flight``: the span log and the routing decisions
    equal the JAX launcher's with the same flags (they depend on the
    traffic and the plan, not on the weights, which each launcher draws
    with its own generator)."""
    import sys
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve
    flags = ["--size", "smoke", "--churn", "--requests", "4", "--gen", "6",
             "10", "--quiet"]
    out = {}
    for side in ("jax", "torch"):
        paths = [str(tmp_path / f"{side}.{k}.jsonl")
                 for k in ("trace", "flight")]
        argv = flags + ["--trace", paths[0], "--flight", paths[1]]
        if side == "torch":
            t_serve.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            j_serve.main()
        out[side] = [open(p).read() for p in paths]
    assert out["torch"] == out["jax"]
    flight = [json.loads(line) for line in out["torch"][1].splitlines()]
    assert any(r["cause"] == "reroute" for r in flight)
    from repro_torch.obs.export import load_trace_file
    assert t_obs.validate_trace_events(load_trace_file(
        str(tmp_path / "torch.trace.jsonl"))) == []
