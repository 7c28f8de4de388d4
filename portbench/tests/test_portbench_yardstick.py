"""The frozen FLOP, parameter and byte counts against numbers worked by
hand for both configurations."""
import pytest

from portbench.harness import manifest, weights, yardstick
from portbench.reference import planner

DENSE = manifest.family_module("dense")


def cfg(name):
    return manifest.cell(name)["config"]


GPT = "gpt2xl.fusion-adatopk.b2s1024"
NEMO = "nemo12b-l6.fusion-adatopk.b8s128"


def test_gpt2_xl_matmul_parameters():
    # 48 blocks of 4 d^2 (q, k, v, o) + 2 d d_ff, and the head d x 50,432
    by_hand = 48 * (4 * 1600 ** 2 + 2 * 1600 * 6400) + 1600 * 50432
    assert by_hand == 1_555_251_200
    assert 48 * DENSE.matmul_params(cfg(GPT)) + 1600 * 50432 == by_hand


def test_gpt2_xl_step_flops_at_2x1024():
    # 6 N T for the weights, plus 3 x 4 B S^2 H hd L for full-square attention
    weights_part = 6 * 1_555_251_200 * 2048
    attention = 3 * 4 * 2 * 1024 ** 2 * 25 * 64 * 48
    assert attention == pytest.approx(1.9327e12, rel=1e-4)
    assert 3 * 48 * DENSE.attention_flops(cfg(GPT), 2, 1024) == attention
    assert yardstick.step_flops(cfg(GPT), 2, 1024) == pytest.approx(
        weights_part + attention, rel=1e-12)
    assert yardstick.step_flops(cfg(GPT), 2, 1024) == pytest.approx(
        2.104e13, rel=1e-3)


def test_nemo_l6_parameters():
    c = cfg(NEMO)
    q, kv = 32 * 128, 8 * 128
    block = 5120 * q + 2 * 5120 * kv + q * 5120 + 3 * 5120 * 14336
    assert block == 272_629_760
    head = 5120 * 131072
    assert DENSE.matmul_params(c) == block
    assert 6 * block + head == 2_306_867_200
    norms = 6 * 2 * 5120 + 5120
    total = 6 * block + 2 * head + norms
    assert weights.count(c, "fusion", 128) == total
    assert total == pytest.approx(2.98e9, rel=2e-3)
    assert weights.count(c, "gspmd", 128) == total


def test_gpt2_xl_parameters_both_layouts():
    c = cfg(GPT)
    blk = 4 * 1600 ** 2 + 2 * 1600 * 6400 + 4 * 1600
    total = 48 * blk + 50432 * 1600 * 2 + 1024 * 1600 + 2 * 1600
    assert weights.count(c, "fusion", 1024) == total
    assert weights.count(c, "gspmd", 1024) == total


def test_codec_bytes_by_hand():
    # a block output at 2 x 1024 x 1600: 800 blocks, k 41
    n = 2 * 1024 * 1600
    enc, dec = yardstick.codec_bytes(n, 41)
    wire = 800 * 41 * 4 + 800 * 128 * 4
    assert (enc, dec) == (n * 4 + wire, wire + n * 4)
    assert yardstick.step_codec_bytes([(n, 41)]) == 2 * (enc + dec)


def test_planned_edges_of_the_cells():
    g = cfg(GPT)
    uni = planner.plan(g, 2, 1024, "uniform", 100.0)
    assert len(uni["stages"]) == 24 and len(uni["edges"]) == 23
    shapes = planner.codec_shapes(g, 2, 1024, uni["edges"])
    assert (2 * 1024 * 1600, 41) in shapes
    ada = planner.plan(g, 8, 128, "adatopk", 100.0)
    assert ada["edges"] == {("block_6", "block_7"): 300.0}
    nemo = planner.plan(cfg(NEMO), 8, 128, "adatopk", 100.0)
    assert nemo["edges"] == {("head", "loss"): 300.0}
    assert planner.codec_shapes(cfg(NEMO), 8, 128, nemo["edges"]) == [
        (8 * 128 * 131072, 14)]
