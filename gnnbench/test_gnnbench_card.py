"""On the card: one short run of each cell at a smaller node count, its
in-degree and widths kept, through the kernels, correct, with every
per-layer metric read from the device trace.  Skips without a card."""
import time

import pytest

from gnnbench import harness
from gnnbench.conftest import cells

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("workload", cells())
def test_cell_on_the_card(bench, card, workload, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    # other test files may have loaded JAX into this process; the check
    # that a run loads none is the CPU rehearsal's, in a fresh interpreter
    monkeypatch.setattr(harness, "check_modules", lambda: None)
    cell = harness.load_cell(bench, workload)
    n = 1 << 16                  # the cell's in-degree and widths
    small = {"n_nodes": n, "n_edges": cell.cfg["n_edges"] * n
             // cell.cfg["n_nodes"]}
    out = harness.run_cell(bench, workload, 2 ** 31 + 99, 1.0, True,
                           device="cuda", t_start=time.perf_counter(),
                           cfg_overrides=small)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, (name, m)
    assert out["device"]["busy_s"] > 0
