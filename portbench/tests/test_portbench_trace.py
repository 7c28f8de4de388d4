"""The trace reader on a hand-made trace: busy and idle seconds, the
operations by name, and the idle gaps by the host's span."""
import pytest
import torch

from portbench.harness import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_and_gaps():
    events = [ev("user_annotation", "window", 1000, 100),
              ev("user_annotation", "executor", 1000, 60),
              ev("user_annotation", "update", 1060, 30),
              ev("kernel", "gemm", 990, 30),       # starts before the window
              ev("kernel", "gemm", 1010, 20),      # overlaps the first
              ev("kernel", "add", 1050, 5),
              ev("gpu_memcpy", "copy", 1070, 10),
              ev("kernel", "late", 1200, 10)]      # after the window
    t = trace.DeviceTrace(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((30 + 5 + 10) * 1e-6)
    assert t.kernel_s("gemm") == pytest.approx(40e-6)
    assert t.device_ops()[0] == ["gemm", pytest.approx(40e-6)]
    gaps = dict((n, s) for n, s in t.idle_gaps())
    # a gap goes to the span the host was in when it began: 1030-1050 and
    # 1055-1070 to executor, 1080-1100 to update
    assert gaps["executor"] == pytest.approx(35e-6)
    assert gaps["update"] == pytest.approx(20e-6)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card_and_reads_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys
    import json
    from portbench.harness import manifest
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2xl.gspmd.b2s1024", "--seed", "4294967311", "--seconds",
         "2", "--trace", "1"], cwd=manifest.ROOT, capture_output=True,
        text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert {"mfu", "device_idle_pct"} <= set(out["metrics"])
