"""Exporters: Chrome/Perfetto trace-event JSON and Prometheus text —
the port's copy of ``repro.obs.export``: the same documents and text
from the same spans and metrics.

``chrome_trace`` emits the Trace Event Format (the JSON flavor both
``chrome://tracing`` and https://ui.perfetto.dev load directly): one
``ph: "X"`` complete event per recorded span, timestamps/durations in
MICROseconds, span attrs under ``args`` (plus the recorded nesting
``depth``, which lets tooling rebuild the flame graph without relying on
timestamp containment).  The metrics registry rides along under a
top-level ``deal_metrics`` key — Perfetto ignores unknown keys, so one
file carries the whole telemetry picture.

Events recorded with a ``_track`` attr (the engine's per-query
``serve.query`` timelines) render on their own named thread row instead
of the main pipeline track, so long-lived query spans don't visually
swallow the nested step/gather flame graph.

``prometheus_text`` renders the registry in the Prometheus exposition
format (``# TYPE`` lines; dotted names sanitized to underscores;
histograms as summaries with p50/p95 quantile samples).
"""
from __future__ import annotations

import json
import re
from typing import Optional

from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer

TRACE_PID = 0
TRACE_TID = 0


def chrome_trace(tracer: Tracer,
                 metrics: Optional[MetricsRegistry] = None,
                 process_name: str = "deal",
                 extra: Optional[dict] = None) -> dict:
    events = [{"name": "process_name", "ph": "M", "pid": TRACE_PID,
               "tid": TRACE_TID, "args": {"name": process_name}}]
    tracks = {}                 # track label -> tid (1, 2, ...)
    for name, t0, dur, depth, attrs in tracer.events_in_order():
        args = dict(attrs) if attrs else {}
        tid = TRACE_TID
        track = args.pop("_track", None)
        if track is not None:
            tid = tracks.get(track)
            if tid is None:
                tid = tracks[track] = len(tracks) + 1
                events.append({"name": "thread_name", "ph": "M",
                               "pid": TRACE_PID, "tid": tid,
                               "args": {"name": str(track)}})
        args["depth"] = depth
        events.append({"name": name,
                       "cat": name.split(".", 1)[0],
                       "ph": "X",
                       "ts": t0 / 1e3,          # us
                       "dur": dur / 1e3,        # us
                       "pid": TRACE_PID,
                       "tid": tid,
                       "args": args})
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if tracer.n_dropped:
        out["deal_dropped_spans"] = tracer.n_dropped
    if metrics is not None:
        out["deal_metrics"] = metrics.to_dict()
    if extra:
        out.update(extra)
    return out


def dump_chrome_trace(tracer: Tracer, path,
                      metrics: Optional[MetricsRegistry] = None,
                      process_name: str = "deal",
                      extra: Optional[dict] = None) -> dict:
    doc = chrome_trace(tracer, metrics, process_name=process_name,
                       extra=extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def prometheus_text(metrics: MetricsRegistry, prefix: str = "deal") -> str:
    """Prometheus exposition text: counters/gauges as single samples,
    histograms as summaries (sum + count + p50/p95 quantiles)."""
    lines = []
    for m in sorted(metrics, key=lambda m: m.name):
        name = f"{prefix}_{_prom_name(m.name)}" if prefix else \
            _prom_name(m.name)
        if isinstance(m, Histogram):
            s = m.summary()
            lines.append(f"# TYPE {name} summary")
            lines.append(f"{name}{{quantile=\"0.5\"}} {s['p50']:g}")
            lines.append(f"{name}{{quantile=\"0.95\"}} {s['p95']:g}")
            lines.append(f"{name}_sum {s['sum']:g}")
            lines.append(f"{name}_count {s['count']}")
        else:
            lines.append(f"# TYPE {name} {m.kind}")
            lines.append(f"{name} {m.value:g}")
    return "\n".join(lines) + ("\n" if lines else "")
