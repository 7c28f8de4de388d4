"""Rules of the port: ``repro_torch`` imports neither JAX nor the JAX
package, its kernels are built from the repository's sources, and its entry
points run on ``cuda`` unless given another device."""
import ast
import inspect
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert bad == []
    smoke = ROOT / "chip_smoke.py"
    assert [m for m in _imports(smoke)
            if m.split(".")[0] in ("jax", "jaxlib", "repro")] == []


def test_kernel_sources_live_in_the_port():
    from repro_torch.kernels import topk_compress as tk
    src = PORT / "kernels" / "csrc" / "topk_codec.cu"
    assert src.is_file()
    text = src.read_text()
    for needle in ("topk_encode", "topk_decode", "__ballot_sync", "__popc",
                   "src/repro/kernels/topk_compress.py"):
        assert needle in text
    assert tk.build_dir() == ROOT / "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import DecentralizedRuntime, network, schedule_opfence
    from repro_torch.configs import resolve
    from repro_torch.launch import train
    from repro_torch.models.opgraph_models import gpt_opgraph

    sig = inspect.signature(DecentralizedRuntime.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(train.train_fusion).parameters[
        "device"].default == "cuda"
    assert inspect.signature(train.train_gspmd).parameters[
        "device"].default == "cuda"
    cfg = resolve("gpt2-xl").smoke
    graph = gpt_opgraph(cfg, 2, 8)
    prof = graph.annotate({"tokens": (2, 8), "labels": (2, 8)})
    sch = schedule_opfence(graph, prof, network.paper_testbed(1, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        DecentralizedRuntime(graph, sch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_fusion(cfg, batch=2, seq=8, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_gspmd(cfg, batch=2, seq=8, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--mode", "fusion", "--steps", "1", "--quiet"])
    DecentralizedRuntime(graph, sch, device="cpu")
    from repro_torch.elastic import ChurnTrace, ElasticController
    assert inspect.signature(ElasticController.__init__).parameters[
        "device"].default == "cuda"
    cluster = network.paper_testbed(1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticController(graph, prof, cluster, ChurnTrace(()))
    ctrl = ElasticController(graph, prof, cluster, ChurnTrace(()),
                             device="cpu")
    assert ctrl.runtime.device.type == "cpu"


def test_cuda_wrappers_refuse_other_devices():
    from repro_torch.kernels import topk_compress as tk
    x = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.encode_topk(x, 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.decode_topk(torch.ones(1, 4, device="meta"),
                       torch.zeros(1, 128, dtype=torch.int32, device="meta"),
                       (64,))


def test_serving_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.base import ModelCfg
    from repro_torch.core.network import homogeneous_lan
    from repro_torch.elastic import ChurnTrace, MembershipView
    from repro_torch.launch import serve
    from repro_torch.models import causal_lm
    from repro_torch.serving import (ServingCostModel, ServingRuntime,
                                     StageExecutor, derive_midsession_failure,
                                     plan_serving, poisson_trace,
                                     split_stages, stage_params)

    for fn in (ServingRuntime.__init__, StageExecutor.__init__,
               derive_midsession_failure):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert serve.build_parser().parse_args([]).device == "cuda"
    cfg = ModelCfg(name="t", family="dense", n_layers=2, d_model=16,
                   n_heads=2, n_kv_heads=2, d_ff=32, vocab=31)
    params = causal_lm.init(cfg, torch.Generator().manual_seed(0))
    plan = plan_serving(cfg, ServingCostModel(cfg, homogeneous_lan(2)),
                        [0, 1], n_stages=2, cache_len=16)
    spec = split_stages(cfg, 2)[0]
    reqs = poisson_trace(2, 100.0, cfg.vocab, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        StageExecutor(cfg, spec, stage_params(cfg, params, spec), 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingRuntime(cfg, params, plan, MembershipView(2, ChurnTrace(())))
    with pytest.raises(RuntimeError, match="CUDA"):
        derive_midsession_failure(cfg, params, plan, reqs, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--quiet"])
    with pytest.raises(TypeError):
        causal_lm.cache_init(cfg, 1, 8)     # the caller names the device
    StageExecutor(cfg, spec, stage_params(cfg, params, spec), 16, "cpu")
