"""The yardstick's counts, pinned to the figures the benchmark states."""

import json

import pytest

from tiny_cells import ROOT
from benchmark.harness import work


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" /
                       f"{name}.json").read_text())["config"]


@pytest.mark.parametrize("name, params", [
    ("mistral-7b-v0.2", 1_875_972_096),
    # the top-2 routed experts of each layer, not the dense dispatch's 8
    ("mixtral-8x7b", 3_285_520_384),
])
def test_routed_params(name, params):
    assert work.routed_params(_config(name)) == params


@pytest.mark.parametrize("name, B, T, flops", [
    ("mistral-7b-v0.2", 4, 4096, 1.976e14),
    ("mixtral-8x7b", 2, 4096, 1.681e14),
    ("mistral-7b-v0.2", 1, 32768, 5.799e14),
])
def test_model_flops_a_step(name, B, T, flops):
    assert work.model_flops(_config(name), B, T) == pytest.approx(
        flops, rel=5e-4)


def test_moe_flops_count_routed_experts_not_the_dense_dispatch():
    cfg = _config("mixtral-8x7b")
    dense = dict(cfg, num_experts_per_tok=cfg["num_local_experts"])
    assert work.model_flops(dense, 2, 4096) > 3.5 * work.model_flops(
        cfg, 2, 4096) - 3 * 12 * 8 * 2 * 4096 ** 2 * 4096


@pytest.mark.parametrize("T", [4096, 32768])  # fused B2; B3 + B4
def test_backward_is_five_products(T):
    w = work.attention_work(_config("mistral-7b-v0.2"), 1, T)
    assert w["bwd"]["flops"] == 2.5 * w["fwd"]["flops"]
    # one exponential a score element: the two-kernel route's recompute
    # of S and dP is not counted as useful work
    assert w["bwd"]["exps"] == w["fwd"]["exps"]


def test_attention_forward_count_and_bound():
    cfg = _config("mistral-7b-v0.2")
    w = work.attention_work(cfg, 4, 4096)["fwd"]
    pairs = 4 * 32 * 4096 * 4097 // 2
    assert w["flops"] == 4 * 128 * pairs
    assert w["exps"] == pairs
    # q and o over 32 heads, k and v over 8, lse in f32
    assert w["bytes"] == 2 * (4 * 4096 * 32 * 128 * 2) + 2 * (
        4 * 4096 * 8 * 128 * 2) + 4 * 32 * 4096 * 4
    ms, by = work.bound(w["bytes"], w["flops"], exps=w["exps"])
    assert by == "operations"
    assert ms == pytest.approx(w["flops"] / 989e12 * 1e3)
    assert work.attention_bound_ms(cfg, 4, 4096, "fwd") == pytest.approx(
        8 * ms)


def test_bound_takes_the_larger_term():
    assert work.bound(3.35e12, 0) == (pytest.approx(1e3), "bytes")
    assert work.bound(0, 0, exps=3.9e12) == (pytest.approx(1e3),
                                             "operations")
    assert work.causal_pairs(4, True) == 10
    assert work.causal_pairs(4, False) == 16
