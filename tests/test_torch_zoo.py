"""The registered dense configurations that ``tests/test_torch_decode.py``
does not serve (mistral-nemo-12b, stablelm-12b, granite-3-8b) against the
JAX package at smoke size, on the same weights, on the CPU: prefill + 4
decode steps with every cache leaf, and decode against the port's own
forward.  Then granite-smoke's 2-stage chain, whose last stage holds the
tied embedding as its head, against the monolithic model bit for bit; the
vlm's launcher fault, which the port mirrors: neither package's train
launcher can train internvl2-2b, because ``SyntheticLM`` makes no patch
embeddings; and the serve launcher's defaults, on which neither package's
planner can place a full-size config in fp32.

Tolerances are those of ``tests/test_torch_decode.py`` (logits rtol 1e-5,
atol 1e-6; caches atol 1e-5); the stage chain is exact.
"""
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import resolve as t_resolve  # noqa: E402
from repro_torch.models import causal_lm as t_lm  # noqa: E402
from repro_torch import serving as t_srv  # noqa: E402
from test_torch_decode import (check_decode_logits_equal_own_forward,  # noqa: E402
                               check_prefill_and_decode_match_jax)

ZOO_LMS = ["mistral-nemo-12b", "stablelm-12b", "granite-3-8b"]


@pytest.mark.parametrize("name", ZOO_LMS)
def test_prefill_and_decode_match_jax(name):
    check_prefill_and_decode_match_jax(name)


@pytest.mark.parametrize("name", ZOO_LMS)
def test_decode_logits_equal_own_forward(name):
    check_decode_logits_equal_own_forward(name)


def test_tied_head_stage_chain_equals_monolithic_bit_for_bit():
    """granite-smoke (tied embeddings) over 2 stages: the last stage hosts
    ``embed`` (a view of the model's table, no copy) and no ``head``, and
    the chain's logits equal ``prefill`` / ``decode_step``'s bit for bit
    over a prefill and 4 greedy decode steps at batch 2."""
    cfg = t_resolve("granite-3-8b").smoke
    assert cfg.tie_embeddings
    params = t_lm.init(cfg, torch.Generator().manual_seed(0))
    specs = t_srv.split_stages(cfg, 2)
    hosted = [t_srv.stage_params(cfg, params, s) for s in specs]
    assert "head" not in params and "head" not in hosted[1]
    assert hosted[1]["embed"]["table"].data_ptr() == \
        params["embed"]["table"].data_ptr()
    assert "final_norm" not in hosted[0]
    cache_len, S = 16, 6
    execs = [t_srv.StageExecutor(cfg, s, sp, cache_len, "cpu")
             for s, sp in zip(specs, hosted)]
    prompt = torch.randint(0, cfg.vocab, (2, S),
                           generator=torch.Generator().manual_seed(1))
    ref, cache = t_lm.prefill(cfg, params, prompt, cache_len=cache_len)
    x, kvs = prompt, []
    for ex in execs:
        x, kv = ex.prefill(x)
        kvs.append(kv)
    for step in range(5):
        assert x.shape == ref.shape and torch.equal(x, ref), step
        if step == 4:
            break
        tok = torch.argmax(ref[:, -1, :], dim=-1)[:, None]
        ref, cache = t_lm.decode_step(cfg, params, cache, tok)
        x = tok
        for i, ex in enumerate(execs):
            x, kvs[i] = ex.decode(x, kvs[i], S + step)


ARGS = ["--arch", "internvl2-2b", "--steps", "1", "--batch", "2", "--seq",
        "16"]


def test_vlm_launcher_fails_in_both_packages(monkeypatch):
    """A fault of the reference that the port mirrors: the train launcher
    draws ``SyntheticLM`` batches, which hold no ``prefix_embeds``, so
    the vlm's forward raises in both packages.  The port does not make
    patch embeddings behind the caller's back; the vlm trains through
    ``steps.make_train_step`` with a batch that holds them."""
    from repro.launch import train as j_train
    from repro_torch.launch import train as t_train
    with pytest.raises(ValueError,
                       match="internvl2-smoke requires prefix_embeds"):
        t_train.main(ARGS + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train"] + ARGS)
    with pytest.raises(ValueError,
                       match="internvl2-smoke requires prefix_embeds"):
        j_train.main()


@pytest.mark.parametrize("arch", ["llama3-8b", "mistral-nemo-12b",
                                  "stablelm-12b", "granite-3-8b",
                                  "deepseek-moe-16b"])
def test_serve_launcher_defaults_cannot_plan_full_size(arch):
    """The serve launcher's defaults (``geo_random(6, seed=0)``, 2 stages,
    cache 64, 4 slots) cannot place these configurations at full size in
    fp32, in either package: a stage's weights outgrow a simulated card
    of 8-24 GB.  Both planners refuse with the same message."""
    from repro.configs import resolve as j_resolve
    from repro.core import network as j_net
    from repro import serving as j_srv
    from repro_torch.core import network as t_net
    errors = []
    for resolve, net, srv in ((j_resolve, j_net, j_srv),
                              (t_resolve, t_net, t_srv)):
        cfg = resolve(arch).full
        with pytest.raises(srv.ServingPlanError) as e:
            srv.plan_serving(cfg, srv.ServingCostModel(
                cfg, net.geo_random(6, seed=0)), list(range(6)),
                n_stages=2, cache_len=64, max_batch=4)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "cannot host stage0" in errors[0]
