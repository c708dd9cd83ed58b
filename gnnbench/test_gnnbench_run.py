"""The harness end to end on the CPU at a tiny size: without a card the
command prints nothing and fails; a rehearsal of every cell loads no JAX
and no ``repro``; a sound run is ``correct``, and each fault that the
cells can have makes it false."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gnnbench import harness
from gnnbench.conftest import cells, tiny

ROOT = Path(__file__).resolve().parents[1]
TINY = tiny()


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT / 'src'}:{ROOT}"
    return env


def test_command_without_a_card_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run")
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                          cells()[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=_env())
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA card" in out.stderr


REHEARSAL = r"""
import json, sys, time
from gnnbench import harness
harness.TRACE_DIR = harness.Path(sys.argv[1])
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
tiny = json.loads(sys.argv[2])
outs = {}
for w in bench["workloads"]:
    for trace in (False, True):
        outs[f"{w['name']}/{int(trace)}"] = harness.run_cell(
            bench, w["name"], 2 ** 33 + 17, 0.2, trace, device="cpu",
            t_start=time.perf_counter(), cfg_overrides=tiny)
print(json.dumps({"forbidden": harness.forbidden_modules(), "outs": outs}))
"""


def test_rehearsal_of_every_cell_loads_no_jax_and_is_correct(bench,
                                                             tmp_path):
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(tmp_path),
                          json.dumps(TINY)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["forbidden"] == []
    for key, res in doc["outs"].items():
        name, trace = key.split("/")
        assert res["correct"] is True, (key, res["checks"])
        assert list(res)[-1] == "checks"
        assert set(res["checks"]) == set(
            json.loads((ROOT / "gnnbench" / "cells" / f"{name}.json")
                       .read_text())["limits"])
        kind = "per_layer" if trace == "1" else "end_to_end"
        allowed = {m["name"] for m in bench[kind]
                   if name in m.get("workloads", [name])}
        assert set(res["metrics"]) <= allowed
        if trace == "0":
            assert set(res["metrics"]) == allowed
        else:
            # what a CPU run can read: the host's clock and the spans
            assert {"construct_s", "sample_s", "ops_ms",
                    "bind_prepare_ms"} <= set(res["metrics"])
            assert "breakdown" in res


# -- faults: the timed path broken underneath, ``correct`` must fail ----

def _real(model):
    from repro_torch.core.layerwise import LOCAL_ENGINES
    return LOCAL_ENGINES[model]


def _unchanged(base):
    """An epoch that hands its input back as its output."""
    def run(lgs, X, params, executor):
        return torch.as_tensor(X, device=executor.device).clone()
    return run


def _half_the_slots(base):
    """Each row's aggregation over the first half of its sampled slots,
    the mean taken over those alone."""
    from repro_torch.core.sampler import LayerGraph

    def run(lgs, X, params, executor):
        half = [LayerGraph(lg.nbr, lg.mask & (np.arange(lg.fanout)
                                              < lg.fanout // 2), lg.fanout)
                for lg in lgs]
        return base(half, X, params, executor=executor)
    return run


def _one_answer_altered(base):
    """One node's embedding changed where the epoch produces it."""
    def run(lgs, X, params, executor):
        H = base(lgs, X, params, executor=executor)
        H[H.shape[0] // 3, 1] += H.abs().mean()
        return H
    return run


FAULTS = [None, _unchanged, _half_the_slots, _one_answer_altered]
FAULT_IDS = ["sound", "unchanged", "half_the_slots", "one_answer_altered"]


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
@pytest.mark.parametrize("workload", cells())
def test_faults_make_the_run_incorrect(bench, workload, fault, tmp_path,
                                       monkeypatch):
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    # this process may hold JAX from other test files; the check that a
    # run loads none is the rehearsal's, in a fresh interpreter
    monkeypatch.setattr(harness, "check_modules", lambda: None)
    model = harness.load_cell(bench, workload).cfg["model"]
    out = harness.run_cell(bench, workload, 31337, 0.05, False,
                           device="cpu", t_start=time.perf_counter(),
                           cfg_overrides=TINY,
                           engine=fault(_real(model)) if fault else None)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == (0 if fault is None else 1)


# -- a typed model, declared by its own reference module ------------------
#
# Two node types and two relations, per-relation weights, vector params
# (a bias, a scale) and a head of another width: the steps that R-GAT
# asks of the harness, in a module that exists only in this test.  Its
# engine stands in for the port's, from the port's own layer graphs and
# ``params_from_numpy``'s tree.

TOY = "toy_typed"
TOY_CELL = "toy-typed.s6-4"
TOY_CFG = {"name": "toy-typed", "model": TOY, "n_layers": 2,
           "d_feature": 16, "hidden_size": 32, "n_classes": 8, "heads": 1,
           "n_nodes": 1024, "n_edges": 6144,
           "node_types": {"paper": 700, "author": 324},
           "relations": [{"name": "cites", "src": "paper", "dst": "paper",
                          "n_edges": 4096, "undirected": True},
                         {"name": "writes", "src": "author",
                          "dst": "paper", "n_edges": 2048}],
           "executor": {"name": "ref"}}


def _toy_widths(cfg):
    d = [cfg["d_feature"]] + [cfg["hidden_size"]] * cfg["n_layers"]
    return list(zip(d[:-1], d[1:]))


def _toy_param_shapes(cfg):
    R = len(cfg["relations"])
    return {"layers": [{"w_self": ((a, b), "fan_in"),
                        "w_rel": ((R, a, b), "fan_in"),
                        "bias": ((b,), 0.1), "scale": ((b,), (0.5, 1.5))}
                       for a, b in _toy_widths(cfg)],
            "head": {"w": ((cfg["hidden_size"], cfg["n_classes"]),
                           "fan_in"),
                     "b": ((cfg["n_classes"],), 0.1)}}


def _toy_epoch_flops(cfg, n, widths, stats):
    R = len(cfg["relations"])
    return (sum((1 + R) * 2 * n * a * b + 2 * st["nnz"] * a
                for (a, b), st in zip(widths, stats))
            + 2 * n * cfg["hidden_size"] * cfg["n_classes"])


def _toy_embed(h, layer_graphs, tree, mm):
    """The reference: a slot's relation from its ends' type blocks, a
    mean a relation over the live slots, each through its own weight."""
    dev = h.device
    off = torch.tensor(tree["node_offsets"], device=dev)
    table = torch.tensor(tree["relation_table"], device=dev)

    def kind(ids):
        return torch.searchsorted(off[1:], ids, right=True)
    t_self = kind(torch.arange(h.shape[0], device=dev))
    for l, (nbr, mask) in enumerate(layer_graphs):
        p = {k: torch.as_tensor(v, device=dev)
             for k, v in tree["layers"][l].items()}
        nbr = torch.as_tensor(nbr, device=dev).long()
        mask = torch.as_tensor(mask, device=dev)
        rel = table[t_self[:, None], kind(nbr)]
        out = mm(h, p["w_self"])
        for r in range(p["w_rel"].shape[0]):
            live = (mask & (rel == r)).to(torch.float32)
            w = live / live.sum(dim=1, keepdim=True).clamp(min=1)
            out = out + mm((w[..., None] * h[nbr]).sum(dim=1),
                           p["w_rel"][r])
        h = out * p["scale"] + p["bias"]
        if l < len(layer_graphs) - 1:
            h = torch.relu(h)
    head = {k: torch.as_tensor(v, device=dev)
            for k, v in tree["head"].items()}
    return mm(h, head["w"]) + head["b"]


def _toy_engine(lgs, X, params, executor):
    """The program's side: the type of an id by a host search of the
    offsets that ``params_from_numpy`` passed through, a relation's sum
    slot by slot, then over its live slots' count."""
    dev = executor.device
    bounds = params["node_offsets"][1:-1]
    table = np.asarray(params["relation_table"])
    h = torch.as_tensor(X, device=dev)
    t_self = np.searchsorted(bounds, np.arange(h.shape[0]), side="right")
    for l, lg in enumerate(lgs):
        p = params["layers"][l]
        rel = np.where(lg.mask, table[t_self[:, None],
                                      np.searchsorted(bounds, lg.nbr,
                                                      side="right")], -1)
        nbr = torch.as_tensor(lg.nbr.astype(np.int64), device=dev)
        out = h @ p["w_self"]
        for r in range(p["w_rel"].shape[0]):
            on = torch.as_tensor(rel == r, device=dev)
            agg = torch.zeros_like(h)
            for f in range(lg.fanout):
                agg += on[:, f, None] * h[nbr[:, f]]
            out = out + (agg / on.sum(dim=1).clamp(min=1)[:, None]
                         ) @ p["w_rel"][r]
        h = out * p["scale"] + p["bias"]
        if l < len(lgs) - 1:
            h = torch.relu(h)
    return h @ params["head"]["w"] + params["head"]["b"]


@pytest.fixture
def toy_bench(bench, tmp_path, monkeypatch):
    """A benchmark of the one toy cell: its configuration, traffic and
    limits written under ``tmp_path``, its reference module and the
    port's acceptance of its tree in place for the test alone."""
    import types
    from repro_torch.core import gnn_models
    mod = types.ModuleType(f"gnnbench.reference.{TOY}")
    mod.param_shapes, mod.layer_widths = _toy_param_shapes, _toy_widths
    mod.epoch_flops, mod.embed = _toy_epoch_flops, _toy_embed
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    port = gnn_models.params_from_numpy
    monkeypatch.setattr(gnn_models, "params_from_numpy",
                        lambda model, tree, device: (
                            gnn_models.params_to(tree, device)
                            if model == TOY else port(model, tree, device)))
    for sub, name, doc in (
            ("configs", TOY_CFG["name"], TOY_CFG),
            ("traffic", "toy6-4", {"name": "toy6-4", "loop": "closed",
                                   "fanouts": [6, 4]}),
            ("cells", TOY_CELL, {"limits": {"rel_l2": 1e-5,
                                            "max_err": 1e-4}})):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / f"{name}.json").write_text(json.dumps(doc))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path / "trace")
    monkeypatch.setattr(harness, "check_modules", lambda: None)
    return {"configs": [{"name": TOY_CFG["name"],
                         "file": str(tmp_path / "configs"
                                     / f"{TOY_CFG['name']}.json")}],
            "workloads": [{"name": TOY_CELL, "config": TOY_CFG["name"],
                           "traffic": "toy6-4", "chips": 1}],
            "end_to_end": bench["end_to_end"],
            "per_layer": [dict(m, workloads=[TOY_CELL])
                          for m in bench["per_layer"] if m["name"] == "mfu"]}


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_a_typed_model_runs_through_the_harness(toy_bench, fault):
    """The toy's sound run is ``correct``, traced, with ``mfu`` from its
    own FLOPs; each fault makes it false."""
    trace = fault is None
    out = harness.run_cell(toy_bench, TOY_CELL, 2 ** 33 + 3, 0.05, trace,
                           device="cpu", t_start=time.perf_counter(),
                           engine=fault(_toy_engine) if fault
                           else _toy_engine)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["info"]["n_edges"] == 2 * 4096 + 2048
    if trace:
        assert out["checks"]["rel_l2"]["value"] < 1e-6
        assert out["metrics"]["mfu"]["value"] > 0
