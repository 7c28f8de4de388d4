"""No run loads JAX, jaxlib, flax or the JAX package: top-level names are
compared whole, so the port (``repro_torch``) is not mistaken for the JAX
package (``repro``)."""
import json
import subprocess
import sys

from portbench.harness import cell, manifest


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert cell.forbidden_modules() == ["repro"]


def test_a_small_run_loads_none_of_them():
    code = (
        "import sys, time, json, torch\n"
        f"sys.path[:0] = [{str(manifest.ROOT)!r}, "
        f"{str(manifest.ROOT / 'src')!r}, {str(manifest.BENCH / 'tests')!r}]\n"
        "from smallcells import small\n"
        "from portbench.harness import cell\n"
        "n = 'gpt2xl.fusion-adatopk.b2s1024'\n"
        "out = cell.run(n, 3, 0.1, False, torch.device('cpu'), time.time(),"
        " cell=small(n))\n"
        "print(json.dumps(cell.forbidden_modules()))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    (tmp_path / "portbench").symlink_to(manifest.BENCH)
    (tmp_path / "BENCHMARK.json").write_text(
        (manifest.ROOT / "BENCHMARK.json").read_text())
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2xl.gspmd.b2s1024", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout.strip() == ""
