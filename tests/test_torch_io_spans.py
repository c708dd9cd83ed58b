"""The binding's own spans and byte counter (``core.ops``) and the
port's spans on the profiler's clock (``obs``): one ``io.bind`` a layer
graph, one ``io.mean_w`` a layer that reads mean weights, one
``io.prepare`` an epoch, their ``h2d_bytes`` the bound arrays' bytes and
the ``io.h2d_bytes`` counter their sum where the arrays go to a card,
nothing on the CPU (the mean weights are built on the mask's device, so
their span copies nothing); a span while ``torch.profiler`` records is its
range, falsy without telemetry, and ``NOOP_SPAN`` again once it
stops."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.gnn_models import init_gat, init_sage  # noqa: E402
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.layerwise import LOCAL_ENGINES  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402

N, F, D = 128, 4, 8
IO = {"io.bind", "io.mean_w", "io.prepare"}


def _world(model):
    src, dst = rmat_edges(N, 6 * N, seed=3)
    lgs = sample_layer_graphs(csr_from_edges(src, dst, N), fanout=F,
                              n_layers=2, seed=5)
    X = np.random.default_rng(0).standard_normal((N, D), dtype=np.float32)
    gen = torch.Generator().manual_seed(0)
    params = (init_sage(gen, [D, D, D]) if model == "sage"
              else init_gat(gen, [D, D, D], heads=2))
    return lgs, X, params


def _epoch(model, executor="cuda"):
    """One tiny epoch on the CPU under enabled telemetry: its spans by
    name, in order, and its counters."""
    lgs, X, params = _world(model)
    tel = obs.Telemetry(enabled=True, clock=obs.FakeClock(0, 1000))
    with obs.use(tel):
        LOCAL_ENGINES[model](lgs, X, params, executor=executor,
                             device="cpu")
    spans = [ev for ev in tel.tracer.events_in_order() if ev[0] in IO]
    return lgs, X, spans, tel.counters


def _by_name(spans):
    out = {}
    for name, _, _, depth, attrs in spans:
        out.setdefault(name, []).append((depth, attrs))
    return out


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_sage_epoch_records_a_bind_a_layer_graph_and_a_mean_w_a_layer(
        executor, monkeypatch):
    """Counted as copies to a card (the CPU copies nothing), each span's
    ``h2d_bytes`` is its arrays' bytes as bound: int32 ids, a bool mask
    and f32 features; the mean weights are built from the bound mask on
    its device, so ``io.mean_w`` copies 0 bytes; the counter is their
    sum."""
    monkeypatch.setattr(ops, "_h2d", lambda a, t: True)
    lgs, X, spans, counters = _epoch("sage", executor)
    got = _by_name(spans)
    assert sorted(got) == sorted(IO)
    assert [a for _, a in got["io.bind"]] == [
        {"rows": N, "fanout": F, "h2d_bytes": N * F * (4 + 1)}
        for _ in lgs]
    assert [a for _, a in got["io.mean_w"]] == [
        {"rows": N, "h2d_bytes": 0} for _ in lgs]
    assert [a for _, a in got["io.prepare"]] == [
        {"rows": N, "h2d_bytes": X.nbytes}]
    # no span of its own encloses the builds or prepare: the harness's
    # probes around them stay at depth 0
    assert {d for d, _ in got["io.bind"] + got["io.prepare"]} == {0}
    assert {d for d, _ in got["io.mean_w"]} == {1}        # in ops.spmm
    assert counters["io.h2d_bytes"] == sum(
        a["h2d_bytes"] for _, _, _, _, a in spans)


def test_gat_epoch_builds_no_mean_weights(monkeypatch):
    monkeypatch.setattr(ops, "_h2d", lambda a, t: True)
    lgs, X, spans, counters = _epoch("gat")
    got = _by_name(spans)
    assert sorted(got) == ["io.bind", "io.prepare"]
    assert len(got["io.bind"]) == len(lgs)
    assert counters["io.h2d_bytes"] == len(lgs) * N * F * 5 + X.nbytes


def test_a_table_is_bound_as_the_loaders_int64(monkeypatch):
    monkeypatch.setattr(ops, "_h2d", lambda a, t: True)
    tel = obs.Telemetry(enabled=True)
    nbr = np.zeros((N, F), np.int64)
    with obs.use(tel):
        io = ops.DenseIO(nbr, nbr > 0, table=np.arange(N), device="cpu")
    (_, _, _, _, attrs), = tel.tracer.events_in_order()
    assert attrs["h2d_bytes"] == N * F * 5 + N * 8
    assert io.table.dtype == torch.int32


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_the_cpu_copies_nothing_to_a_card(model):
    _, _, spans, counters = _epoch(model)
    assert spans and all(a["h2d_bytes"] == 0 for *_, a in spans)
    assert counters.get("io.h2d_bytes", 0) == 0


def test_disabled_without_a_profiler_is_the_noop_span():
    from torch.profiler import ProfilerActivity, profile
    assert not obs.profiling()
    assert obs.span("io.bind") is obs.NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.profiling()
        assert obs.span("io.bind") is not obs.NOOP_SPAN
    assert not obs.profiling()
    assert obs.span("io.bind") is obs.NOOP_SPAN


@pytest.mark.parametrize("enabled", [False, True])
def test_spans_are_ranges_in_the_profilers_trace(enabled, tmp_path):
    """Under ``torch.profiler`` every span is a ``user_annotation`` of its
    name; without telemetry it is falsy, so no call site sets attrs or
    synchronizes, and with it the tracer records it as well."""
    from torch.profiler import ProfilerActivity, profile
    lgs, X, params = _world("sage")
    tel = obs.Telemetry(enabled=enabled)
    with obs.use(tel), profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("io.bind") as sp:
            assert bool(sp) is enabled
            sp.set(rows=1)
        LOCAL_ENGINES["sage"](lgs, X, params, executor="cuda",
                              device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("io.bind") == 1 + len(lgs)
    assert names.count("io.mean_w") == len(lgs)
    assert names.count("io.prepare") == 1
    assert {"ops.gemm", "ops.spmm"} <= set(names)
    recorded = {ev[0] for ev in tel.tracer.events_in_order()}
    assert (IO | {"ops.gemm", "ops.spmm"} <= recorded) is enabled
