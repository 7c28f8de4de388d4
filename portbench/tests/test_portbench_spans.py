"""The reader of the program's spans on a hand-made trace: device time,
launches and idle a span, a backward launch from another host thread, an
``attn`` backward found by its ``fwdbwd`` flow, and the trace reader's
own readings left as they were."""
import pytest

from portbench.harness import spans, trace


def ev(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def launch(corr, ts, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return ev(cat, name, ts, 1, tid, correlation=corr)


def kernel(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def flow(ph, ident, ts, tid):
    e = {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": ident, "ts": ts,
         "pid": 1, "tid": tid}
    if ph == "f":
        e["bp"] = "e"
    return e


BASE = [ev("user_annotation", "window", 1000, 200),
        ev("user_annotation", "executor", 1000, 100),
        ev("user_annotation", "update", 1100, 60),
        kernel(10, 995, 6, name="gemm"),        # launched before the window
        kernel(1, 1004, 6, name="gemm"),
        kernel(2, 1010, 8, name="softmax"),
        kernel(3, 1023, 2, cat="gpu_memcpy", name="copy"),
        kernel(4, 1040, 3, name="gemm"),
        kernel(5, 1046, 10, name="gemm"),
        kernel(6, 1086, 2, name="div"),
        kernel(7, 1103, 10, name="mul"),
        kernel(8, 1113, 7, name="add"),
        kernel(99, 1160, 5, name="late")]      # no launch call in the trace

PROGRAM = [ev("user_annotation", "rad.step", 1000.5, 89.5),
           ev("user_annotation", "rad.fwd.s0", 1002, 18),
           ev("user_annotation", "attn", 1005, 10),
           ev("user_annotation", "rad.wire", 1021, 4),
           ev("user_annotation", "rad.bwd.s0", 1030, 30),
           ev("user_annotation", "optim.update", 1101, 39),
           launch(10, 990), launch(1, 1003), launch(2, 1006),
           launch(3, 1022, name="cudaMemcpyAsync"),
           launch(4, 1036, tid=2), launch(5, 1045, tid=2), launch(6, 1085),
           launch(7, 1102), launch(8, 1105, cat="cuda_driver",
                                   name="cuLaunchKernel"),
           ev("cuda_runtime", "cudaStreamSynchronize", 1150, 5,
              correlation=9),
           # the forward's matmul in attn, its backward on tid 2
           ev("cpu_op", "aten::mm", 1006, 3), flow("s", 70, 1006, 1),
           ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
              1034.5, 6, tid=2),
           ev("cpu_op", "MmBackward0", 1035, 5, tid=2),
           flow("f", 70, 1035, 2),
           # an op of the forward outside attn, and its backward
           ev("cpu_op", "aten::mul", 1003, 1), flow("s", 80, 1003, 1),
           ev("cpu_op", "MulBackward0", 1044, 14, tid=2),
           flow("f", 80, 1044, 2)]


def test_span_readings_are_exact():
    t = spans.SpanTrace(BASE + PROGRAM)
    got = spans.readings(t, steps=1)
    # optim.update launched the mul (10 us) and, by the driver, the add (7)
    assert got["update_device_ms"] == pytest.approx(17e-3)
    assert got["update_launches"] == 2
    # gaps begun in rad.step: 1001-1004, 1018-1023, 1025-1040, 1043-1046,
    # 1056-1086, 1088-1103
    assert got["executor_idle_ms"] == pytest.approx(71e-3)
    # attn's softmax (8 us) and the gemm its MmBackward0 launched from the
    # backward's thread (3 us); MulBackward0's gemm is not attention's
    assert got["attn_ms"] == pytest.approx(11e-3)
    assert spans.readings(t, steps=2)["update_launches"] == 1


def test_backward_launches_from_another_thread_count_in_its_span():
    t = spans.SpanTrace(BASE + PROGRAM)
    assert t.launches("rad.bwd.s0") == 2
    assert t.device_s("rad.bwd.s0") == pytest.approx(13e-6)
    assert t.idle_s("rad.bwd.s0") == pytest.approx(33e-6)   # 1043, 1056
    table = t.table(steps=1)
    assert table["rad.step"]["launches"] == 6
    # the gap from 1025 begins as the wire's span ends: the wire's, as
    # idle_gaps counts a gap at a span's end
    assert table["rad.wire"] == {"device_ms": pytest.approx(2e-3),
                                 "launches": 1,
                                 "idle_ms": pytest.approx(15e-3)}
    # what rad.step launched outside every other span: the div
    assert table[spans.STEP_SELF] == {"device_ms": pytest.approx(2e-3),
                                      "launches": 1}


def test_attention_without_its_flows_is_the_forward_alone():
    no_flows = [e for e in PROGRAM if e["cat"] != "fwdbwd"]
    t = spans.SpanTrace(BASE + no_flows)
    assert t.device_s("attn") == pytest.approx(8e-6)


def test_a_program_without_spans_reads_nothing():
    t = spans.SpanTrace(BASE)
    assert spans.readings(t, steps=3) == {}
    assert t.table(steps=3) == {}


def test_the_trace_readers_own_readings_are_unchanged():
    before = trace.DeviceTrace(BASE)
    for t in (trace.DeviceTrace(BASE + PROGRAM),
              spans.SpanTrace(BASE + PROGRAM)):
        assert t.window_s == before.window_s == pytest.approx(200e-6)
        assert t.busy_s == before.busy_s == pytest.approx(54e-6)
        assert t.device_ops() == before.device_ops()
        assert t.idle_gaps() == before.idle_gaps()
        assert t.spans == before.spans
        assert t.kernel_s("gemm") == before.kernel_s("gemm")
    gaps = dict(before.idle_gaps())
    assert gaps["executor"] == pytest.approx(71e-6)
    assert gaps["update"] == pytest.approx(40e-6)
    assert gaps["host"] == pytest.approx(35e-6)
