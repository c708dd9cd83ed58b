"""``rgat_rel_ms``: the device time an epoch of the kernels issued inside
the port's ``ops.rel_*`` ranges (R-GAT's relation projections, their
scores and softmax, the attend), over the traced epochs (after the
profiler's first).  Each kernel is placed by the host time of the
runtime call that shares its ``correlation``, as
``iotrace.htod_copies`` places copies.  None where the trace holds no
``ops.rel_*`` range."""
import os

from gnnbench import devtrace, iotrace

PREFIX = "ops.rel_"


def kernel_seconds(events, prefix: str = PREFIX):
    """(seconds of the kernels issued inside ``prefix`` ranges in the
    traced window, epochs), or None without such a range there."""
    w = iotrace.window(events)
    if w is None:
        return None
    t0, t1, n = w
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(prefix) and t0 <= e["ts"] < t1)
    if not ranges:
        return None
    issued = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat") not in devtrace.DEVICE_CATS:
            issued[corr] = e["ts"]
    total = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        at = issued.get(e.get("args", {}).get("correlation"))
        if at is not None and any(a <= at < b for a, b in ranges):
            total += e["dur"] * 1e-6
    return total, n


def read(ctx):
    from gnnbench import harness
    if not ctx.trace.get("epochs"):
        return None
    path = harness.TRACE_DIR / f"{ctx.cell.name}.trace.json"
    if not os.path.exists(path):
        return None
    got = kernel_seconds(devtrace.load(path))
    return None if got is None else got[0] / got[1] * 1e3
