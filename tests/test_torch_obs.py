"""The port's obs layer against ``repro.obs`` (mirrors tests/test_obs.py):
span records and nesting under a fake clock, the ring buffer that drops
the oldest span, span histograms with executor attribution, coverage,
``use`` scoping, the disabled span as a shared falsy no-op that
allocates nothing, strict metric typing; then exact parity with the
JAX package — the same spans give the same Chrome trace document, the
same metric operations the same Prometheus text, and validation,
report and check give the same results on the same documents; and the
port's ``Session`` end to end: ``dump_trace`` passes both packages'
validators, needs telemetry, ``capacity`` is honoured, and instrumented
runs are bitwise equal to uninstrumented ones."""
import copy
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import validate as jvalidate  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import ConfigError, DealConfig, Session  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.validate import DEFAULT_CATS, validate_trace  # noqa


def _tel(pkg=obs, **kw):
    return pkg.Telemetry(enabled=True, clock=pkg.FakeClock(0, 1000), **kw)


# ----------------------------------------------------------------------
# spans: nesting, ordering, deterministic clock
# ----------------------------------------------------------------------

def test_span_records_name_duration_depth():
    tel = _tel()
    with tel.span("a"):
        pass
    (name, t0, dur, depth, attrs), = tel.tracer.events
    assert (name, t0, dur, depth, attrs) == ("a", 0, 1000, 0, None)


def test_span_nesting_depths_and_order():
    tel = _tel()
    with tel.span("outer"):
        with tel.span("inner1"):
            pass
        with tel.span("inner2") as sp:
            sp.set(rows=7)
    assert [e[0] for e in tel.tracer.events_in_order()] == \
        ["inner1", "inner2", "outer"]
    ev = {e[0]: e for e in tel.tracer.events}
    assert {k: e[3] for k, e in ev.items()} == {"outer": 0, "inner1": 1,
                                                "inner2": 1}
    assert ev["inner2"][4] == {"rows": 7}
    for child in ("inner1", "inner2"):
        assert ev["outer"][1] <= ev[child][1]
        assert (ev[child][1] + ev[child][2]
                <= ev["outer"][1] + ev["outer"][2])


@pytest.mark.parametrize("n_spans", [2, 3, 5, 8])
def test_ring_buffer_drops_the_oldest_as_repro_does(n_spans):
    got = []
    for pkg in (obs, jobs):
        tel = _tel(pkg, capacity=3)
        for i in range(n_spans):
            with tel.span(f"s{i}"):
                pass
        got.append((tel.tracer.events_in_order(), tel.tracer.n_dropped))
    assert got[0] == got[1]
    assert got[0][1] == max(n_spans - 3, 0)
    assert [e[0] for e in got[0][0]] == \
        [f"s{i}" for i in range(max(n_spans - 3, 0), n_spans)]


def test_span_feeds_duration_histogram_with_executor_attribution():
    tel = _tel()
    with tel.span("ops.spmm") as sp:
        sp.set(executor="cuda")
    d = tel.metrics.to_dict()
    assert d["ops.spmm_ms.count"] == 1
    assert d["ops.spmm.cuda_ms.count"] == 1
    assert d["ops.spmm_ms.sum"] == pytest.approx(1e-3)      # 1000 ns


def test_coverage_interval_union_and_clear():
    tel = _tel()
    with tel.span("a"):        # [0, 1000]
        pass
    tel.tracer.clock.advance(8000)
    with tel.span("b"):        # [10000, 11000]
        pass
    assert tel.tracer.window_ns() == (0, 11000)
    assert tel.tracer.covered_ns() == 2000
    assert tel.tracer.coverage() == pytest.approx(2000 / 11000)
    agg = tel.tracer.aggregate()
    assert agg["a"] == {"count": 1, "total_ms": 1e-3, "max_ms": 1e-3}
    tel.clear()
    assert tel.tracer.events == [] and tel.tracer.window_ns() == (0, 0)
    assert list(tel.metrics) == []


def test_use_scopes_and_restores():
    tel = _tel()
    assert not obs.enabled()
    with obs.use(tel):
        assert obs.enabled() and obs.current() is tel
        with obs.span("x"):
            pass
        obs.add("c", 2)
    assert not obs.enabled()
    assert [e[0] for e in tel.tracer.events] == ["x"]
    assert tel.metrics.counter("c").value == 2
    assert tel.counters == {"c": 2}


def test_disabled_span_is_shared_falsy_noop():
    assert obs.span("anything") is obs.NOOP_SPAN
    assert not obs.NOOP_SPAN
    with obs.span("anything") as sp:
        assert sp is obs.NOOP_SPAN
        sp.set(rows=1)
    assert obs.DISABLED.span("x") is obs.NOOP_SPAN


def test_disabled_hot_path_allocates_nothing():
    def hot():
        with obs.span("x") as sp:
            if sp:
                sp.set(rows=1)
        obs.add("c")
        obs.observe("h", 1.0)
        obs.gauge("g", 2.0)

    hot()
    deltas = []
    for _ in range(5):
        before = sys.getallocatedblocks()
        hot()
        deltas.append(sys.getallocatedblocks() - before)
    assert min(deltas) <= 0


def test_metrics_registry_strict_typing():
    tel = _tel()
    tel.add("x", 1)
    with pytest.raises(TypeError, match="counter"):
        tel.metrics.histogram("x")


# ----------------------------------------------------------------------
# exporters: the same documents as repro's
# ----------------------------------------------------------------------

def _golden(pkg):
    """The same span and metric operations on either package."""
    tel = _tel(pkg)
    with tel.span("serve.step"):
        with tel.span("store.gather") as sp:
            sp.set(rows=4, level=1)
        with tel.span("ops.spmm", {"executor": "x"}):
            pass
    tel.tracer.record("serve.query", 500, 2000, 0,
                      {"_track": "queries", "uid": 3})
    tel.add("store.evictions", 2)
    tel.gauge("store.util", 0.5)
    tel.observe("serve.queue_wait_ms", 1.5)
    tel.observe("serve.queue_wait_ms", 2.5)
    return tel


def test_chrome_trace_equals_repro(tmp_path):
    tel, jtel = _golden(obs), _golden(jobs)
    extra = {"deal_health": {"n_alerts": 0}}
    doc = obs.dump_chrome_trace(tel.tracer, tmp_path / "t.json",
                                tel.metrics, process_name="deal.test",
                                extra=extra)
    jdoc = jobs.dump_chrome_trace(jtel.tracer, tmp_path / "j.json",
                                  jtel.metrics, process_name="deal.test",
                                  extra=extra)
    assert doc == jdoc
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert doc == json.loads((tmp_path / "t.json").read_text())
    meta, gather, spmm, step, track, query = doc["traceEvents"]
    assert meta == {"name": "process_name", "ph": "M", "pid": 0,
                    "tid": 0, "args": {"name": "deal.test"}}
    assert gather == {"name": "store.gather", "cat": "store", "ph": "X",
                      "ts": 1.0, "dur": 1.0, "pid": 0, "tid": 0,
                      "args": {"rows": 4, "level": 1, "depth": 1}}
    assert track["ph"] == "M" and query["tid"] == 1
    assert doc["deal_metrics"]["store.evictions"] == 2
    assert doc["deal_health"] == {"n_alerts": 0}


def test_chrome_trace_of_a_wrapped_ring_equals_repro():
    docs = []
    for pkg in (obs, jobs):
        tel = _tel(pkg, capacity=2)
        for i in range(5):
            with tel.span(f"stage{i}.x"):
                pass
        docs.append(pkg.chrome_trace(tel.tracer, tel.metrics))
    assert docs[0] == docs[1]
    assert docs[0]["deal_dropped_spans"] == 3


def test_prometheus_text_equals_repro():
    text = obs.prometheus_text(_golden(obs).metrics)
    assert text == jobs.prometheus_text(_golden(jobs).metrics)
    assert "# TYPE deal_store_evictions counter\n" \
           "deal_store_evictions 2" in text
    assert 'deal_serve_queue_wait_ms{quantile="0.95"} 2.5' in text
    assert "deal_serve_step_ms_count 1" in text
    assert obs.prometheus_text(obs.MetricsRegistry()) == ""


# ----------------------------------------------------------------------
# validation and report: the same results as repro's
# ----------------------------------------------------------------------

def _docs():
    """Good and bad trace documents."""
    good = obs.chrome_trace(_golden(obs).tracer, _golden(obs).metrics)
    gap = copy.deepcopy(good)
    gap["traceEvents"].append({"name": "late.x", "ph": "X", "ts": 1e6,
                               "dur": 1.0, "pid": 0, "tid": 0})
    bad_ev = {"traceEvents": [{"name": "a", "ph": "X", "ts": -1, "dur": 2,
                               "pid": 0, "tid": 0},
                              {"name": "", "ph": "X", "ts": 0, "dur": 1},
                              {"name": "b", "ph": "B", "ts": 0},
                              {"name": "c", "ph": "X", "ts": 0, "dur": 1},
                              7]}
    attrib = copy.deepcopy(good)
    attrib["deal_attribution"] = {"t": {
        "n_queries": 1, "e2e_ms": {"p50": 1.0, "p95": 2.0},
        "segments_frac": {s: 0.1 for s in report.SEGMENTS},
        "attributed_frac": 0.8}}
    query_no_attrib = copy.deepcopy(good)
    query_no_attrib["traceEvents"].append(
        {"name": "serve.query", "ph": "X", "ts": 0, "dur": 5, "pid": 0,
         "tid": 0, "args": {"uid": 1, "tenant": "t", "gather_ms": 1.0}})
    alert = copy.deepcopy(good)
    alert["traceEvents"].append(
        {"name": "health.alert", "ph": "X", "ts": 2, "dur": 0, "pid": 0,
         "tid": 0, "args": {"kind": "slo_burn", "subject": "t",
                            "depth": 0, "burn": 5.0}})
    alert["deal_health"] = {"alerts": [], "burn_rate": {"t": 5.0}}
    return {"good": good, "gap": gap, "bad_events": bad_ev,
            "not_a_list": {"traceEvents": "nope"}, "root": [1],
            "empty": {"traceEvents": []}, "attribution": attrib,
            "query_without_attribution": query_no_attrib, "alert": alert}


@pytest.mark.parametrize("name", list(_docs()))
@pytest.mark.parametrize("cats,spans", [
    ((), ()), (("serve", "store"), ()), (tuple(DEFAULT_CATS.split(",")), ()),
    (("serve",), ("store.gather", "refresh.layer"))])
def test_validate_trace_equals_repro(name, cats, spans):
    doc = _docs()[name]
    for cov in (0.0, 0.9):
        got = validate_trace(doc, cov, cats, spans)
        assert got == jvalidate.validate_trace(doc, cov, cats, spans)
    if name == "good":
        assert validate_trace(doc, 0.9, ("serve", "store"))[0] == []


@pytest.mark.parametrize("name", [n for n in _docs()
                                  if isinstance(_docs()[n], dict)
                                  and n not in ("not_a_list",
                                                "bad_events")])
def test_report_and_check_equal_repro(name):
    doc = _docs()[name]
    assert report.stage_breakdown(doc) == jreport.stage_breakdown(doc)
    assert report.check_trace(doc) == jreport.check_trace(doc)
    if report.check_trace(doc) != ["trace contains no span events"]:
        assert report.render_report(doc, 3) == jreport.render_report(doc, 3)


def test_trajectory_gate_equals_repro(tmp_path):
    def entry(share_a, fail=()):
        return {"executor": "ref", "smoke": True, "failures": list(fail),
                "benches": {"b": {"stages": {
                    "a": {"count": 1, "total_ms": 100 * share_a},
                    "z": {"count": 1, "total_ms": 100 * (1 - share_a)}}}}}
    for entries in ([], [entry(0.2)], [entry(0.2)] * 3 + [entry(0.2)],
                    [entry(0.2)] * 3 + [entry(0.9)],
                    [entry(0.2), entry(0.2, ["b"])]):
        got = report.check_trajectory(entries)
        assert got == jreport.check_trajectory(entries)
        assert report.render_trajectory(entries) == \
            jreport.render_trajectory(entries)
    path = tmp_path / "traj.json"
    path.write_text(json.dumps([entry(0.2)] * 3 + [entry(0.9)]))
    assert report.main(["--trajectory", str(path)]) == 1
    assert report.load_trajectory(tmp_path / "missing.json") == []


# ----------------------------------------------------------------------
# end to end: Session telemetry
# ----------------------------------------------------------------------

def _small_cfg(executor="ref", telemetry=False, model="gcn", **tel):
    cfg = DealConfig.from_dict({
        "graph": {"dataset": "rmat", "n_nodes": 256, "avg_degree": 8,
                  "fanout": 4},
        "model": {"name": model, "n_layers": 2,
                  "d_feature": 32 if model == "gat" else 16,
                  "heads": 4 if model == "gat" else 1},
        "executor": {"name": executor},
        "qos": {"staleness_bound": 8}})
    cfg.telemetry.enabled = telemetry
    for k, v in tel.items():
        setattr(cfg.telemetry, k, v)
    return cfg


@pytest.mark.parametrize("model", ["gcn", "gat"])
@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_instrumentation_is_bitwise_neutral(executor, model):
    with Session.build(_small_cfg(executor, model=model),
                       device="cpu") as off:
        H_off = off.infer_all().clone()
        eng = off.serve()
        off.apply_mutations().add_edges(np.array([1, 2]), np.array([3, 4]))
        off.refresh()
        rows_off = eng.store.lookup(np.arange(256), -1)
    with Session.build(_small_cfg(executor, True, model=model),
                       device="cpu") as on:
        H_on = on.infer_all().clone()
        eng = on.serve()
        on.apply_mutations().add_edges(np.array([1, 2]), np.array([3, 4]))
        on.refresh()
        rows_on = eng.store.lookup(np.arange(256), -1)
        assert len(on.telemetry.tracer.events) > 0
    assert torch.equal(H_off, H_on)
    np.testing.assert_array_equal(rows_off, rows_on)


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_session_dump_trace_passes_both_validators(tmp_path, executor):
    """A served, mutated and refreshed session under telemetry dumps a
    trace that both packages' validators and report checks accept."""
    from repro_torch.gnnserve import Query
    with Session.build(_small_cfg(executor, telemetry=True),
                       device="cpu") as s:
        s.infer_all()
        eng = s.serve()
        for i in range(4):
            eng.submit(Query(uid=i, node_ids=np.arange(8) + i))
            s.apply_mutations().add_edges(np.array([i]), np.array([i + 1]))
            eng.run()
        s.refresh()
        doc = s.dump_trace(tmp_path / "trace.json")
        assert s.prometheus_text().startswith("# TYPE")
        assert s.prometheus_text() == obs.prometheus_text(
            s.telemetry.metrics)
    assert doc == json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"][0]["args"]["name"] == "deal.gcn"
    assert {"deal_metrics", "deal_attribution", "deal_top_queries",
            "deal_health"} <= set(doc)
    cats = tuple(DEFAULT_CATS.split(","))
    spans = ("refresh.layer", "serve.query", "session.executor_build")
    for validate in (validate_trace, jvalidate.validate_trace):
        problems, summary = validate(doc, 0.9, cats, spans)
        assert problems == [] and summary["coverage"] >= 0.9
    assert report.check_trace(doc) == jreport.check_trace(doc) == []
    assert jvalidate.main([str(tmp_path / "trace.json")]) == 0
    from repro_torch.obs import validate as tvalidate
    assert tvalidate.main([str(tmp_path / "trace.json"),
                           "--require-spans", ",".join(spans)]) == 0
    assert report.main([str(tmp_path / "trace.json"), "--check"]) == 0


def test_dump_trace_without_telemetry_raises():
    with Session.build(_small_cfg(), device="cpu") as s:
        assert s.telemetry is None
        with pytest.raises(ConfigError, match="telemetry"):
            s.dump_trace("/tmp/never.json")
        assert s.prometheus_text() == ""


def test_session_installs_and_restores_current_telemetry():
    assert obs.current() is obs.DISABLED
    with Session.build(_small_cfg(telemetry=True), device="cpu") as s:
        assert obs.current() is s.telemetry
    assert obs.current() is obs.DISABLED


def test_telemetry_spec_roundtrip_and_capacity_is_honoured():
    cfg = _small_cfg(telemetry=True, clock="fake", capacity=5)
    cfg2 = DealConfig.from_json(cfg.to_json())
    assert cfg2.telemetry == cfg.telemetry
    tel = cfg2.telemetry.build()
    assert isinstance(tel.tracer.clock, obs.FakeClock)
    assert tel.tracer.capacity == 5
    with Session.build(cfg2, device="cpu") as s:
        s.infer_all()
        tr = s.telemetry.tracer
        assert len(tr.events) == 5 and tr.n_dropped > 0
        # the newest spans survive: the last one recorded is the epoch's
        assert tr.events_in_order()[-1][0] == "session.infer_all"
    cfg.telemetry.clock = "sundial"
    with pytest.raises(ConfigError, match="clock"):
        cfg.validate()
