"""Reading a profiler trace: the window after the first epoch, the
device's busy time, the kernels, and the idle gaps with their labels,
on a hand-made trace (microseconds)."""
import json

import pytest

from gnnbench import devtrace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", "gnnbench.epoch", 0, 100),      # warms, left out
    _x("kernel", "void warm_kernel<float>(int)", 10, 50),
    _x("user_annotation", "gnnbench.epoch", 100, 100),
    _x("user_annotation", "gnnbench.epoch", 200, 100),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 100, 40),
    _x("kernel", "void (anonymous namespace)::spmm_kernel<float, 4>"
       "((anonymous namespace)::Args)", 130, 30),         # overlaps the copy
    _x("user_annotation", "bind.mean_w", 165, 30),        # host work
    _x("kernel", "void (anonymous namespace)::spmm_kernel<float, 4>"
       "((anonymous namespace)::Args)", 200, 20),
    _x("cpu_op", "aten::copy_", 240, 10),
]


def test_summary_of_a_hand_made_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    got = devtrace.summarize(devtrace.load(path))
    assert got["epochs"] == 2
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(80e-6)          # 100-160, 200-220
    assert [d for _, d in got["kernels"]] == pytest.approx([30e-6, 20e-6])
    assert got["device_ops"] == [
        ("spmm_kernel<float, 4>", pytest.approx(50e-6)),
        ("Memcpy HtoD (Pageable -> Device)", pytest.approx(40e-6))]
    labels = dict((round(d * 1e6), name) for name, d in got["idle_gaps"])
    assert labels == {80: "host between aten::copy_ and end",
                      40: "bind.mean_w"}


def test_no_epoch_ranges_reads_nothing():
    assert devtrace.summarize([_x("kernel", "k", 0, 1)]) == {"epochs": 0}
