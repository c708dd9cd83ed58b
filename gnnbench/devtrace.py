"""Reading the profiler's trace (``torch.profiler``'s Chrome trace JSON):
the device's activity, its idle gaps and what the host was doing in
them.  Timestamps and durations in the file are microseconds.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
EPOCH_RANGE = "gnnbench.epoch"
TOP = 10                 # device operations and idle gaps reported


def load(path) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def short_name(e: dict) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    parameter list."""
    name = e["name"]
    if e.get("cat") == "kernel":
        name = name.replace("(anonymous namespace)::", "")
        name = name[5:] if name.startswith("void ") else name
        name = name.split("(", 1)[0]
    return name


def epoch_ranges(events: List[dict]) -> List[Tuple[float, float]]:
    """(start, end) of each ``gnnbench.epoch`` range, in time order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"] == EPOCH_RANGE)


def device_events(events: List[dict], t0: float, t1: float) -> List[dict]:
    """Kernels, copies and sets that start inside [t0, t1), time order."""
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS
                   and t0 <= e["ts"] < t1), key=lambda e: e["ts"])


def busy_intervals(dev: List[dict], t0: float, t1: float):
    """The union of the device events' intervals, clipped to [t0, t1]."""
    out: List[List[float]] = []
    for e in dev:
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The idle stretches of [t0, t1] between busy intervals."""
    out, t = [], t0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t1 > t:
        out.append((t, t1))
    return out


def gap_label(gap, host: List[dict]) -> str:
    """What the host was doing in a gap: the innermost host range (a
    ``cpu_op`` or a ``record_function``) that covers the gap's middle;
    else the host ops on either side."""
    mid = (gap[0] + gap[1]) / 2
    inner = None
    for e in host:
        if e["ts"] <= mid < e["ts"] + e["dur"] and (
                inner is None or e["dur"] < inner["dur"]):
            inner = e
    if inner is not None and inner["name"] != EPOCH_RANGE:
        return inner["name"]
    before = [e for e in host if e["ts"] + e["dur"] <= mid
              and e["name"] != EPOCH_RANGE]
    after = [e for e in host if e["ts"] > mid and e["name"] != EPOCH_RANGE]
    prev = max(before, key=lambda e: e["ts"] + e["dur"])["name"] \
        if before else "start"
    nxt = min(after, key=lambda e: e["ts"])["name"] if after else "end"
    return f"host between {prev} and {nxt}"


def summarize(events: List[dict]) -> Dict:
    """The traced window (the epochs after the first, which warms the
    profiler) read from the trace: its length, the device's busy time,
    the device events in it, the ``TOP`` device operations by time and
    the ``TOP`` longest idle gaps, labelled by the host's work.
    Seconds."""
    ranges = epoch_ranges(events)[1:]
    if not ranges:
        return {"epochs": 0}
    t0, t1 = ranges[0][0], ranges[-1][1]
    dev = device_events(events, t0, t1)
    busy = busy_intervals(dev, t0, t1)
    by_name: Dict[str, float] = {}
    for e in dev:
        key = short_name(e)
        by_name[key] = by_name.get(key, 0.0) + e["dur"] * 1e-6
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    idle = sorted(gaps(busy, t0, t1), key=lambda g: g[0] - g[1])[:TOP]
    return {
        "epochs": len(ranges),
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": [(e["name"], e["dur"] * 1e-6) for e in dev
                    if e.get("cat") == "kernel"],
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [(gap_label(g, host), (g[1] - g[0]) * 1e-6)
                      for g in idle],
    }
