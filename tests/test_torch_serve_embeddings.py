"""The port's serving launcher (``repro_torch.launch.serve_embeddings``)
against ``repro.launch.serve_embeddings``: a traced run on the CPU
writes a trace both packages' validators accept, ``--dump-config``
round-trips to the JAX launcher's bytes, the ``build_service`` shim
serves bitwise the rows of ``Session.serve()``, and a launcher run with
a fake clock records the span names of the JAX launcher's run on the
same config."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.launch import serve_embeddings as jse  # noqa: E402
from repro.obs.validate import validate_trace as jvalidate  # noqa: E402
from repro_torch.api import DealConfig, Session  # noqa: E402
from repro_torch.gnnserve import Query  # noqa: E402
from repro_torch.launch import serve_embeddings as se  # noqa: E402
from repro_torch.obs.validate import DEFAULT_CATS, validate_trace  # noqa

SCALE = 256 / 8192          # ogbn-products at 256 nodes
SMALL = ["--dataset", "ogbn-products", "--scale", str(SCALE),
         "--fanout", "4", "--layers", "2", "--d-feature", "16",
         "--staleness-bound", "4"]


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_traced_run_on_the_cpu_validates(tmp_path, capsys, executor):
    path = tmp_path / "trace.json"
    se.main(SMALL + ["--device", "cpu", "--executor", executor,
                     "--ticks", "3", "--trace", str(path)])
    out = capsys.readouterr().out
    assert "[epoch0] 256 nodes" in out and "[trace] wrote" in out
    assert f"executor={executor}" in out
    doc = json.loads(path.read_text())
    cats = tuple(DEFAULT_CATS.split(","))
    spans = ("serve.tick", "serve.drain", "refresh.layer")
    for validate in (validate_trace, jvalidate):
        problems, summary = validate(doc, 0.9, cats, spans)
        assert problems == [], problems
        assert summary["coverage"] >= 0.9


def test_dist_executor_serves_through_the_launcher(tmp_path, capsys):
    """``--executor dist``: the epoch and every refresh on a 4 x 2 mesh
    of CPU shards; the trace carries the mesh's spans and passes both
    packages' validators."""
    path = tmp_path / "trace.json"
    se.main(SMALL + ["--device", "cpu", "--executor", "dist", "--p", "4",
                     "--m", "2", "--ticks", "3", "--trace", str(path)])
    out = capsys.readouterr().out
    assert "executor=dist" in out and "[fresh] last refresh" in out
    doc = json.loads(path.read_text())
    cats = tuple(DEFAULT_CATS.split(","))
    spans = ("serve.tick", "refresh.layer", "dist.subset_plan",
             "dist.subset_plan_build", "dist.exchange")
    for validate in (validate_trace, jvalidate):
        problems, _ = validate(doc, 0.9, cats, spans)
        assert problems == [], problems


def test_dump_config_round_trips_to_the_jax_launchers_bytes(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    flags = SMALL + ["--executor", "ref", "--tenants", "a:2:1:0:4",
                     "--budget-rows", "64", "--chunk-rows", "32"]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    se.main(flags + ["--dump-config", str(ours)])
    monkeypatch.setattr(sys, "argv", ["serve_embeddings"] + flags
                        + ["--dump-config", str(theirs)])
    jse.main()
    assert ours.read_bytes() == theirs.read_bytes()
    cfg = DealConfig.load(ours)
    assert cfg.to_json() == DealConfig.from_json(cfg.to_json()).to_json()
    capsys.readouterr()
    se.main(["--config", str(ours), "--dump-config", "-"])
    dumped = json.loads(capsys.readouterr().out)
    assert dumped == json.loads(ours.read_text())


def test_unported_executor_and_cluster_raise_through_the_session(
        capsys, tmp_path, monkeypatch):
    """The JAX package's "pallas" executor is refused through the
    session; the cluster tier runs through the launcher: two shard
    workers on the CPU, and the ``--kill-shard`` drill kills shard 1
    halfway, restarts it and finds every shard digest equal, as the JAX
    launcher's drill does.  ``--kill-shard`` without a cluster is
    refused."""
    with pytest.raises(SystemExit, match="'pallas' is not in the port"):
        se.main(SMALL + ["--device", "cpu", "--executor", "pallas"])
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the run dir
    se.main(SMALL + ["--device", "cpu", "--executor", "ref", "--ticks",
                     "4", "--cluster-shards", "2", "--kill-shard", "1"])
    out = capsys.readouterr().out
    assert "[cluster] 2 shard workers behind the router" in out
    assert "[cluster] killed shard 1;" in out
    assert "restored=True" in out and "rejoined bitwise-equal" in out
    assert out.count("[serve]") == 2            # the drive, split in two
    with pytest.raises(SystemExit, match="--kill-shard needs"):
        se.main(SMALL + ["--device", "cpu", "--kill-shard", "0"])
    from repro_torch import obs
    assert obs.current() is obs.DISABLED


def _drive_pair(eng_a, eng_b, n):
    """Identical traffic against both engines; returns the query pairs."""
    pairs = []
    for tick in range(4):
        rng = np.random.default_rng(100 + tick)
        ids = rng.integers(0, n, 32)
        qa, qb = Query(uid=tick, node_ids=ids), Query(uid=tick,
                                                      node_ids=ids)
        s_e, d_e = rng.integers(0, n, 4), rng.integers(0, n, 4)
        for eng, q in ((eng_a, qa), (eng_b, qb)):
            eng.submit(q)
            eng.mutate().add_edges(s_e, d_e)
            eng.run()
        pairs.append((qa, qb))
    return pairs


@pytest.mark.parametrize("executor,budget", [("ref", 0), ("cuda", 0),
                                             ("ref", 96)])
def test_build_service_shim_bitwise_equal(executor, budget):
    eng = se.build_service("ogbn-products", "gcn", fanout=4, n_layers=2,
                           d_feature=16, staleness_bound=8,
                           executor=executor, budget_rows=budget,
                           scale=SCALE, device="cpu")
    cfg = DealConfig.from_dict({
        "graph": {"dataset": "ogbn-products", "scale": SCALE, "fanout": 4,
                  "seed": 0, "n_construct_workers": 4},
        "model": {"name": "gcn", "n_layers": 2, "d_feature": 16},
        "partition": {"p": 4, "m": 2},
        "executor": {"name": executor, "fallback_to_ref": False},
        "store": {"n_shards": 4, "budget_rows": budget},
        "qos": {"staleness_bound": 8}})
    with Session.build(cfg, device="cpu") as s:
        other = s.serve()
        n = eng.store.n_nodes
        assert n == other.store.n_nodes == 256
        for qa, qb in _drive_pair(eng, other, n):
            assert qa.done and qb.done
            assert qa.served_version == qb.served_version
            np.testing.assert_array_equal(qa.out, qb.out)
        assert eng.store.version == other.store.version > 0
        if budget:
            assert eng.store.n_evictions > 0


def test_launcher_records_the_jax_launchers_span_names(capsys):
    """The same config through both launchers' own functions, with a
    fake clock: the same span names (and the same queries served),
    besides the binding's ``io.*`` spans, which the JAX package lacks."""
    d = {"graph": {"dataset": "ogbn-products", "scale": SCALE,
                   "fanout": 4, "n_construct_workers": 4},
         "model": {"name": "gcn", "n_layers": 2, "d_feature": 16},
         "executor": {"name": "ref"},
         "store": {"budget_rows": 96, "onboarding": "tail"},
         "qos": {"staleness_bound": 4},
         "refresh": {"chunk_rows": 0},
         "telemetry": {"enabled": True, "clock": "fake"}}
    kw = dict(ticks=4, mutations_per_tick=3, nodes_per_tick=1)
    js = jse._serve_session(japi.DealConfig.from_dict(d))
    try:
        jse.drive(js.engine, **kw)
        want = {ev[0] for ev in js.telemetry.tracer.events_in_order()}
        jserved = js.engine.stats()["n_served"]
    finally:
        js.close()
    with se._serve_session(DealConfig.from_dict(d), "cpu") as s:
        se.drive(s.engine, **kw)
        got = {ev[0] for ev in s.telemetry.tracer.events_in_order()}
        assert s.engine.stats()["n_served"] == jserved
    assert got - want == {"io.bind", "io.mean_w"}
    assert got & want == want
    assert {"serve.tick", "serve.drain", "refresh.layer"} <= got
