"""The port's binding read from its own spans (``iotrace``): idle time
keyed by the innermost port range on a hand-made trace, with the bytes
copied from inside ``io.*`` ranges and nothing read from a trace without
them; the probes' depths under the port's spans on the CPU; the
rehearsal reporting ``io_ms``, ``h2d_gib`` and ``io_idle_ms``; and on the
card, the ``io.h2d_bytes`` counter against the trace's copies."""
import json
import time

import pytest

from gnnbench import devtrace, harness, iotrace
from gnnbench.conftest import cells, tiny


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _copy(ts, dur, nbytes, corr, at):
    """A host-to-card copy on the device and its runtime call at ``at``."""
    return [_x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", ts, dur,
               bytes=nbytes, correlation=corr),
            _x("cuda_runtime", "cudaMemcpyAsync", at, 1, correlation=corr)]


EVENTS = [
    _x("user_annotation", "gnnbench.epoch", 0, 100),      # warms, left out
    _x("user_annotation", "io.bind", 10, 80),
    *_copy(20, 10, 999, 9, 15),
    _x("user_annotation", "gnnbench.epoch", 100, 100),
    _x("user_annotation", "gnnbench.epoch", 200, 100),
    # DenseIO's build: the probe, the port's span, an aten::to inside
    _x("user_annotation", "bind.DenseIO", 100, 40),
    _x("user_annotation", "io.bind", 101, 38),
    _x("cpu_op", "aten::to", 102, 36),
    *_copy(110, 20, 1000, 1, 105),
    # a layer's first spmm: the mean weights under their probe
    _x("user_annotation", "ops.spmm", 140, 50),
    _x("user_annotation", "bind.mean_w", 141, 30),
    _x("user_annotation", "io.mean_w", 142, 28),
    *_copy(160, 5, 500, 2, 150),
    _x("kernel", "void spmm_kernel<float, 4>(Args)", 175, 10),
    *_copy(192, 2, 7, 3, 191),                 # issued outside io.*
    _x("kernel", "void gemm<float>(int)", 200, 100),
]


def test_idle_by_span_keys_each_gap_by_the_innermost_port_range():
    got = iotrace.idle_by_span(EVENTS, iotrace.probe_labels())
    assert got == {"io.bind": pytest.approx(10e-6),      # 100-110
                   "io.mean_w": pytest.approx(30e-6),    # 130-160
                   "ops.spmm": pytest.approx(17e-6),     # 165-175, 185-192
                   "none": pytest.approx(6e-6)}          # 194-200
    assert sum(got.values()) == pytest.approx(
        devtrace.summarize(EVENTS)["window_s"]
        - devtrace.summarize(EVENTS)["busy_s"])
    # a probe is no port range: unlisted, bind.mean_w takes a gap
    assert "bind.mean_w" in iotrace.idle_by_span(EVENTS)


def test_reading_per_epoch_of_a_hand_made_trace():
    got = iotrace.reading(EVENTS, iotrace.probe_labels())
    assert got.epochs == 2
    assert got.io_s == pytest.approx((38 + 28) * 1e-6 / 2)
    assert got.h2d_bytes == (1000 + 500) / 2       # not the warm, not 7
    assert got.io_idle_s == pytest.approx((10 + 30) * 1e-6 / 2)


def test_a_trace_without_io_ranges_reads_nothing():
    old = [e for e in EVENTS if not e["name"].startswith("io.")]
    assert iotrace.reading(old, iotrace.probe_labels()) is None
    assert iotrace.reading([_x("kernel", "k", 0, 1)]) is None


def test_metrics_read_the_runs_trace_file(bench, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    name = cells()[0]
    (tmp_path / f"{name}.trace.json").write_text(
        json.dumps({"traceEvents": EVENTS}))
    ctx = harness.Context(harness.load_cell(bench, name), 1, {}, [1.0],
                          1.0, 0, trace={"epochs": 2})
    assert harness.reader("io_ms")(ctx) == pytest.approx(33e-3)
    assert harness.reader("h2d_gib")(ctx) == 750 / 2 ** 30
    assert harness.reader("io_idle_ms")(ctx) == pytest.approx(20e-3)
    ctx.trace = {}
    assert harness.reader("io_ms")(ctx) is None


@pytest.mark.parametrize("workload", cells())
def test_probes_stay_at_depth_0_under_the_ports_spans(bench, workload):
    """No port span encloses the layer graphs' binding or ``prepare``:
    the probes ``bind.DenseIO`` and ``bind.prepare`` stay at depth 0, so
    ``ops_ms`` subtracts only ``bind.mean_w``, inside a layer's spmm."""
    import torch
    from repro_torch import obs
    cell = harness.load_cell(bench, workload)
    cell.cfg.update(tiny())
    dev = torch.device("cpu")
    prog = harness.set_up(cell, 2 ** 32 + 5, dev)
    tel = obs.Telemetry(enabled=True, clock=obs.FakeClock(0, 1000))
    with obs.use(tel), harness.probes(dev, sync_each=True):
        prog.epoch()
    spans = tel.tracer.events_in_order()

    def depths(name):
        return {d for n, _, _, d, _ in spans if n == name}
    assert depths("bind.DenseIO") == depths("bind.prepare") == {0}
    assert depths("io.bind") == depths("io.prepare") == {1}
    nested = {n for n, _, _, d, _ in spans if n.startswith("bind.") and d}
    sage = cell.cfg["model"] == "sage"
    assert nested == ({"bind.mean_w"} if sage else set())
    assert depths("io.mean_w") == ({2} if sage else set())


def test_the_command_reads_a_tiny_cell_on_the_cpu(bench, tmp_path,
                                                  monkeypatch):
    import torch
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    cell = harness.load_cell(bench, cells()[0])
    cell.cfg.update(tiny())
    got = iotrace.measure(cell, 2 ** 32 + 5, 2, torch.device("cpu"))
    assert len(got["span_epochs"]) == 2
    for e in got["span_epochs"]:
        assert 0 < e["io_s"] and e["covered_s"] <= e["wall_s"]
        assert e["h2d_bytes"] == 0                  # the CPU: no card
    assert got["traced"]["epochs"] >= 3 and got["traced"]["io_ms"] > 0
    traced = got["traced"]
    assert traced["h2d_bytes"] == traced["htod_bytes_all"] == 0


@pytest.mark.parametrize("workload", cells())
def test_rehearsal_reports_the_binding_metrics(bench, workload, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    # the rehearsal in test_gnnbench_run checks, in a fresh interpreter,
    # that a run loads no JAX; this process may hold it
    monkeypatch.setattr(harness, "check_modules", lambda: None)
    out = harness.run_cell(bench, workload, 2 ** 33 + 17, 0.05, True,
                           device="cpu", t_start=time.perf_counter(),
                           cfg_overrides=tiny())
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert {"io_ms", "h2d_gib", "io_idle_ms"} <= set(m)
    assert m["io_ms"] > 0 and m["io_idle_ms"] >= 0
    assert m["h2d_gib"] == 0                        # the CPU: no card


@pytest.mark.gpu
@pytest.mark.parametrize("workload", cells())
def test_counter_is_the_traces_host_to_card_bytes(bench, card, workload,
                                                  tmp_path, monkeypatch):
    """On the card an epoch's ``io.h2d_bytes`` is the bytes of its
    arrays as bound (features f32; each layer graph's ids int32 and mask
    bool: sage's mean weights are built on the card), and the trace's
    ``Memcpy HtoD`` bytes per traced epoch (each copy placed by the
    time it was issued), all of them from inside ``io.*`` ranges, within
    0.1%."""
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    cell = harness.load_cell(bench, workload)
    n = 1 << 16
    cell.cfg.update(n_nodes=n, n_edges=cell.cfg["n_edges"] * n
                    // cell.cfg["n_nodes"])
    prog = harness.set_up(cell, 2 ** 31 + 7, card)
    prog.epoch()
    counter = iotrace.span_epochs(prog, 2)[-1]["h2d_bytes"]
    per_slot = 4 + 1
    assert counter == prog.X.nbytes + sum(lg.nbr.size * per_slot
                                          for lg in prog.lgs)
    harness.profile_epochs(prog.epoch, [1.0], card, workload)
    events = devtrace.load(tmp_path / f"{workload}.trace.json")
    t0, t1, epochs = iotrace.window(events)
    copies = iotrace.htod_copies(events)
    assert all(at is not None for _, at in copies)
    htod = sum(e["args"]["bytes"] for e, at in copies
               if t0 <= at < t1) / epochs
    assert htod == pytest.approx(counter, rel=1e-3)
    got = iotrace.reading(events, iotrace.probe_labels())
    assert got.h2d_bytes == pytest.approx(counter, rel=1e-3)
