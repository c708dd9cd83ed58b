"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name
it holds has its file under ``gnnbench/``."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_tok|d_feature)")


def _text(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for w in cmd:
        if (ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in bench["paths"])


def test_names_and_units_use_the_allowed_characters(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w[k] for w in bench["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(m["better"] in ("lower", "higher")
               for m in bench["end_to_end"] + bench["per_layer"])


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _text(c["source"]) and _text(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(k in cfg and not WIDTH.search(k) for k in c["reduced"])
        assert (HERE / "reference" / f"{cfg['model']}.py").exists()


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((HERE / "cells" / f"{w['name']}.json")
                            .read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in SOURCES_E2E
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _text(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for c in cells:
        mine = [m for m in bench["end_to_end"]
                if c in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(c in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_check_budget_fits(bench):
    """2 + 14 runs a cell at 24 cells, each run_seconds + 60 s, 180 s a
    cell to compile and 1200 s spare, within 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
