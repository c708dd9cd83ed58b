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


def _unchanged(model):
    """An epoch that hands its input back as its output."""
    def run(lgs, X, params, executor):
        return torch.as_tensor(X, device=executor.device).clone()
    return run


def _half_the_slots(model):
    """Each row's aggregation over the first half of its sampled slots,
    the mean taken over those alone."""
    from repro_torch.core.sampler import LayerGraph

    def run(lgs, X, params, executor):
        half = [LayerGraph(lg.nbr, lg.mask & (np.arange(lg.fanout)
                                              < lg.fanout // 2), lg.fanout)
                for lg in lgs]
        return _real(model)(half, X, params, executor=executor)
    return run


def _one_answer_altered(model):
    """One node's embedding changed where the epoch produces it."""
    def run(lgs, X, params, executor):
        H = _real(model)(lgs, X, params, executor=executor)
        H[H.shape[0] // 3, 1] += H.abs().mean()
        return H
    return run


@pytest.mark.parametrize("fault", [None, _unchanged, _half_the_slots,
                                   _one_answer_altered],
                         ids=["sound", "unchanged", "half_the_slots",
                              "one_answer_altered"])
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
                           engine=fault(model) if fault else None)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == (0 if fault is None else 1)
