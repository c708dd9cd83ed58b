"""The yardstick's counts on hand-worked shapes, and the comparison."""
import math

import numpy as np
import pytest
import torch

from gnnbench import reference, yardstick

# 3 rows, fanout 2: live slots (0,0), (0,1), (1,0); rows 0 and 1 live;
# distinct live sources {0, 1}
NBR = np.array([[0, 1], [1, 0], [2, 2]], np.int32)
MASK = np.array([[True, True], [True, False], [False, False]])


@pytest.fixture
def st():
    return yardstick.layer_stats(NBR, MASK)


def test_layer_stats(st):
    assert st == {"R": 3, "F": 2, "nnz": 3, "uniq": 2, "live_rows": 2}


@pytest.mark.parametrize("heads,want", [(1, 6 + 24 + 32 + 48),
                                        (2, 6 + 36 + 32 + 48)])
def test_spmm_bytes(st, heads, want):
    assert yardstick.spmm_bytes(st, 4, heads) == want


def test_gat_attention_bytes(st):
    # q of 2 live rows, 2 distinct k rows, 6 mask bytes, 3 live nbr ids,
    # the (3, 2, 2) f32 attention
    assert yardstick.gat_attention_bytes(st, 4, 2) == 32 + 32 + 6 + 12 + 48


def test_flops(st):
    assert yardstick.kernel_flops(st, 4) == 24
    assert yardstick.epoch_flops("sage", 3, [(4, 4)], [st]) == (
        2 * 2 * 3 * 16 + 24)
    assert yardstick.epoch_flops("gat", 3, [(4, 4), (4, 4)], [st, st]) == (
        2 * (3 * 2 * 3 * 16 + 2 * 24))
    # sage aggregates at its width in, gat attends at its width out
    assert yardstick.epoch_flops("sage", 3, [(4, 8)], [st]) == (
        2 * 2 * 3 * 32 + 2 * 3 * 4)
    assert yardstick.epoch_flops("gat", 3, [(4, 8)], [st]) == (
        3 * 2 * 3 * 32 + 2 * 2 * 3 * 8)


def test_layer_widths():
    cfg = {"d_feature": 100, "hidden_size": 512, "n_layers": 3}
    assert yardstick.layer_widths(cfg) == [(100, 512), (512, 512),
                                           (512, 512)]


def test_bound_takes_the_larger():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
    assert yardstick.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_errors():
    want = torch.full((4, 2), 2.0)
    assert yardstick.errors(want.clone(), want) == {"rel_l2": 0.0,
                                                    "max_err": 0.0}
    got = want.clone()
    got[3, 1] += 1.0
    e = yardstick.errors(got, want)
    assert e["rel_l2"] == pytest.approx(math.sqrt(1 / 32))
    assert e["max_err"] == pytest.approx(0.5)
    got[0, 0] = float("nan")
    assert yardstick.errors(got, want)["rel_l2"] == math.inf
    assert yardstick.errors(want[:3], want)["max_err"] == math.inf


def test_judge():
    ok, checks = yardstick.judge({"rel_l2": 0.05, "max_err": 1.0},
                                 {"rel_l2": 0.1})
    assert ok and checks == {"rel_l2": {"value": 0.05, "limit": 0.1}}
    assert not yardstick.judge({"rel_l2": 0.2}, {"rel_l2": 0.1})[0]
    assert not yardstick.judge({"rel_l2": 0.0}, {})[0]


def test_round_tf32_to_nearest_even():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp, 1 + ulp / 2, 1 + 1.5 * ulp,
                      -(1 + 1.5 * ulp), 3.0, 0.0])
    want = torch.tensor([1 + ulp, 1.0, 1 + 2 * ulp, -(1 + 2 * ulp), 3.0,
                         0.0])
    assert torch.equal(reference.round_tf32(x), want)


# taken before the counts moved into the models' modules
@pytest.mark.parametrize("name,fanouts,n,want", [
    ("sage-papers100m", (25, 10), 4096, 1611904256),
    ("gat-products", (10, 10, 10), 4096, 14155542528),
    ("sage-papers100m", (25, 10), None, 3339694986240),
    ("gat-products", (10, 10, 10), None, 8510656595968)])
def test_epoch_flops_of_each_configuration_are_pinned(name, fanouts, n,
                                                      want):
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).parent / "configs"
                      / f"{name}.json").read_text())
    if n is None:
        n = cfg["n_nodes"]
        stats = [{"nnz": n * f // (i + 2)} for i, f in enumerate(fanouts)]
    else:
        stats = [{"nnz": 1000 * (i + 1) + f} for i, f in enumerate(fanouts)]
    assert yardstick.epoch_flops(cfg["model"], n, yardstick.layer_widths(
        cfg), stats, cfg) == want


def test_slot_width_is_the_models():
    assert yardstick.slot_width("sage", 4, 8) == 4
    assert yardstick.slot_width("gat", 4, 8) == 8


def test_a_model_declares_its_widths_and_flops(monkeypatch):
    import sys
    import types
    mod = types.ModuleType("gnnbench.reference.declared")
    mod.layer_widths = lambda cfg: [(cfg["d_feature"], 6), (6, 6), (6, 3)]
    mod.epoch_flops = lambda cfg, n, widths, stats: (
        n * sum(a * b for a, b in widths) + cfg["extra"]
        + sum(s["nnz"] for s in stats))
    monkeypatch.setitem(sys.modules, "gnnbench.reference.declared", mod)
    cfg = {"model": "declared", "d_feature": 5, "extra": 7}
    widths = yardstick.layer_widths(cfg)
    assert widths == [(5, 6), (6, 6), (6, 3)]
    assert yardstick.epoch_flops("declared", 2, widths, [{"nnz": 1}] * 3,
                                 cfg) == 2 * (30 + 36 + 18) + 7 + 3
