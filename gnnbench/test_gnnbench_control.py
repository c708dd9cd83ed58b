"""The control at a size a test run holds: with the cell's own limits,
the port passes on every seed and the reference computed with TF32
GEMMs in its place fails.  On the card, ``control.py`` reads the same at
the cells' own sizes (the limits' readings in ``cells/<cell>.json``)."""
import pytest

from gnnbench import control, harness
from gnnbench.conftest import cells, tiny

TINY = tiny()


@pytest.mark.parametrize("workload", cells())
def test_control_fails_and_the_port_passes(bench, workload):
    limits = harness.load_cell(bench, workload).limits
    out, summary = control.readings(bench, workload, [5, 6], [5, 6],
                                    device="cpu", cfg_overrides=TINY,
                                    log=lambda s: None)
    for side, seed, errs in out:
        ok, _ = harness.yardstick.judge(errs, limits)
        assert ok is (side == "program"), (side, seed, errs, limits)
    for name, r in summary.items():
        assert r["lower"] < limits[name] < r["upper"], (name, r)
