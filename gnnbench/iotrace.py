"""The port's own stages in the profiler's trace.

While ``torch.profiler`` records, each ``repro_torch.obs`` span is also a
``record_function`` range of its name (a ``user_annotation`` in the
trace): ``io.*`` for the binding (``core.ops``: ``DenseIO``'s build,
its mean weights, ``prepare``), ``ops.*`` for the executor's ops.  Read
over the traced window (``devtrace``: the epochs after the profiler's
first), per epoch: the time in ``io.*`` ranges, the bytes copied host to
card from inside them, and the device's idle time by the port range the
host was in.  A trace without ``io.*`` ranges, from a port that has
none, reads as None.

    python3 -m gnnbench.iotrace --workload gat-products.s10x3 --seed 7

runs one cell's set-up on the card, then epochs untimed by any span,
epochs under the port's spans and the harness's probes, and epochs
under the profiler, and prints one JSON line: each span epoch's wall
time, its ``io.*`` and ``ops.*`` time, the union of the two, and the
``io.h2d_bytes`` counter; the window's median epoch; and what this
module reads from the trace, with every host-to-card copy's bytes.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

from gnnbench import devtrace

IO = "io."
NONE = "none"               # the key of idle time under no port range
HTOD = "Memcpy HtoD"


@dataclasses.dataclass
class IoReading:
    """One trace's reading: the traced epochs' count; per epoch, the
    seconds in ``io.*`` ranges and the bytes copied host to card from
    inside them; and the window's idle seconds by port range."""
    epochs: int
    io_s: float
    h2d_bytes: float
    idle_by_span: Dict[str, float]

    @property
    def io_idle_s(self) -> float:
        """Idle seconds an epoch under ``io.*`` ranges."""
        return sum(v for k, v in self.idle_by_span.items()
                   if k.startswith(IO)) / self.epochs


def probe_labels() -> Tuple[str, ...]:
    from gnnbench import harness
    return tuple(label for *_, label in harness.PROBES)


def port_ranges(events: List[dict], probes=()) -> List[dict]:
    """The port's ranges: ``user_annotation`` events other than the
    harness's epoch range and its probes."""
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] != devtrace.EPOCH_RANGE and e["name"] not in probes]


def window(events: List[dict]) -> Optional[Tuple[float, float, int]]:
    """(start, end, epochs) of the traced window, as ``devtrace``'s."""
    ranges = devtrace.epoch_ranges(events)[1:]
    if not ranges:
        return None
    return ranges[0][0], ranges[-1][1], len(ranges)


def innermost(ranges: List[dict], t: float) -> Optional[dict]:
    """The shortest of ``ranges`` that covers ``t``, or None."""
    inner = None
    for e in ranges:
        if e["ts"] <= t < e["ts"] + e["dur"] and (
                inner is None or e["dur"] < inner["dur"]):
            inner = e
    return inner


def idle_by_span(events: List[dict], probes=()) -> Dict[str, float]:
    """The idle seconds of every gap in the traced window, each keyed by
    the innermost port range covering the gap's middle (``none`` where
    none does); innermost, so that an ``aten::to`` inside ``io.bind`` or
    an ``io.mean_w`` under the ``bind.mean_w`` probe does not take the
    label."""
    w = window(events)
    if w is None:
        return {}
    t0, t1, _ = w
    busy = devtrace.busy_intervals(devtrace.device_events(events, t0, t1),
                                   t0, t1)
    ranges = [e for e in port_ranges(events, probes)
              if e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    out: Dict[str, float] = {}
    for a, b in devtrace.gaps(busy, t0, t1):
        inner = innermost(ranges, (a + b) / 2)
        key = NONE if inner is None else inner["name"]
        out[key] = out.get(key, 0.0) + (b - a) * 1e-6
    return out


def htod_copies(events: List[dict]) -> List[Tuple[dict, Optional[float]]]:
    """Each host-to-card copy on the device with the host time at which
    it was issued: the start of the runtime call that shares its
    ``correlation`` (None where the trace has no such call).  Copies are
    placed in epochs by that time: a copy that starts as soon as it is
    issued can carry a device time a little before its epoch's range."""
    issued = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat") not in devtrace.DEVICE_CATS:
            issued[corr] = e["ts"]
    return [(e, issued.get(e.get("args", {}).get("correlation")))
            for e in events if e.get("cat") == "gpu_memcpy"
            and e["name"].startswith(HTOD)]


def reading(events: List[dict], probes=()) -> Optional[IoReading]:
    """The trace's ``IoReading``, or None without a traced window or
    without an ``io.*`` range in it."""
    w = window(events)
    if w is None:
        return None
    t0, t1, n = w
    io = [e for e in port_ranges(events, probes) if e["name"].startswith(IO)
          and t0 <= e["ts"] < t1]
    if not io:
        return None
    h2d = sum(e["args"].get("bytes", 0) for e, at in htod_copies(events)
              if at is not None and innermost(io, at) is not None)
    return IoReading(n, sum(e["dur"] for e in io) * 1e-6 / n, h2d / n,
                     idle_by_span(events, probes))


@functools.lru_cache(maxsize=1)
def _read_file(path: str, mtime_ns: int, size: int,
               probes: Tuple[str, ...]) -> Optional[IoReading]:
    return reading(devtrace.load(path), probes)


def read(ctx) -> Optional[IoReading]:
    """The reading of the traced run's trace file
    (``harness.profile_epochs``'s), read once for all the metrics."""
    from gnnbench import harness
    if not ctx.trace.get("epochs"):
        return None
    path = harness.TRACE_DIR / f"{ctx.cell.name}.trace.json"
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return _read_file(str(path), st.st_mtime_ns, st.st_size,
                      probe_labels())


# -- the command: the same readings from the port's spans ---------------

def covered_s(spans, prefixes=("ops.", IO)) -> float:
    """Seconds covered by the union of the recorded spans whose names
    start with one of ``prefixes`` (``obs`` span tuples, ns)."""
    total, end = 0, None
    for a, b in sorted((t, t + d) for name, t, d, _, _ in spans
                       if name.startswith(prefixes)):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total * 1e-9


def span_epochs(prog, k: int) -> List[Dict[str, float]]:
    """``k`` epochs under the port's spans and the harness's probes,
    synchronized as the harness's span epochs are: each one's wall time,
    the spans' sums as ``harness.span_epochs`` takes them, its ``io.*``
    spans, the union of ``ops.*`` and ``io.*``, and ``io.h2d_bytes``."""
    import time

    from gnnbench import harness
    from repro_torch import obs
    tel = obs.Telemetry(enabled=True)
    out = []
    with obs.use(tel), harness.probes(prog.device, sync_each=True):
        for _ in range(k):
            tel.clear()
            a = time.perf_counter()
            H = prog.epoch()
            wall = time.perf_counter() - a
            del H
            spans = tel.tracer.events_in_order()

            def total(keep):
                return sum(d for name, _, d, depth, _ in spans
                           if keep(name, depth)) * 1e-9
            out.append({
                "wall_s": wall,
                "ops_s": total(lambda n, d: n.startswith("ops.")),
                "bind_in_ops_s": total(
                    lambda n, d: n.startswith("bind.") and d > 0),
                "io_s": total(lambda n, d: n.startswith(IO)),
                "covered_s": covered_s(spans),
                "h2d_bytes": tel.counters.get("io.h2d_bytes", 0.0)})
    return out


def measure(cell, seed: int, k: int, dev) -> Dict:
    """The command's reading of ``cell`` on ``dev``: set-up and a warm
    epoch, ``k`` epochs untimed by any span, ``k`` under the port's spans
    (``span_epochs``), then the harness's profiled epochs."""
    import statistics
    import time

    from gnnbench import harness
    prog = harness.set_up(cell, seed, dev)
    prog.epoch()
    epochs = []
    for _ in range(k):
        a = time.perf_counter()
        prog.epoch()
        epochs.append(time.perf_counter() - a)
    spans = span_epochs(prog, k)
    summary = harness.profile_epochs(prog.epoch, epochs, dev, cell.name)
    events = devtrace.load(harness.TRACE_DIR / f"{cell.name}.trace.json")
    got = reading(events, probe_labels())
    t0, t1, n = window(events)
    htod = [e["args"].get("bytes", 0) for e, at in htod_copies(events)
            if at is not None and t0 <= at < t1]
    return {"workload": cell.name, "seed": seed,
            "window_epochs_s": epochs,
            "median_epoch_s": statistics.median(epochs),
            "span_epochs": spans,
            "traced": {"epochs": n, "window_s": summary.get("window_s"),
                       "busy_s": summary.get("busy_s"),
                       "io_ms": got.io_s * 1e3 if got else None,
                       "h2d_bytes": got.h2d_bytes if got else None,
                       "io_idle_ms": got.io_idle_s * 1e3 if got else None,
                       "idle_by_span_s": got.idle_by_span if got else None,
                       "htod_bytes_all": sum(htod) / n,
                       "htod_copies": len(htod) / n}}


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    for p in (root / "src", root):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from gnnbench import run
    run.pin_environment()            # before torch is imported
    import torch

    from gnnbench import harness
    cell = harness.load_cell(harness.load_json(root / "BENCHMARK.json"),
                             args.workload)
    harness.require_cards(cell.chips)
    out = measure(cell, args.seed, args.epochs, torch.device("cuda"))
    out.update(card=torch.cuda.get_device_name(0),
               power_limit=harness.power_limit())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
