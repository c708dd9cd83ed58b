"""Live telemetry surface: a stdlib-only HTTP scrape endpoint plus a
periodic JSON snapshot writer — the port's copy of
``repro.obs.endpoint``, with the same routes and snapshot format.

``Session.serve()`` starts a ``TelemetryEndpoint`` when the config's
``TelemetrySpec`` asks for one (``http_port >= 0`` and/or a
``snapshot_path``); ``Session.close()`` stops it.  Everything here is
standard library — no prometheus_client, no web framework.

Routes (GET):

    /metrics    the metrics registry in Prometheus exposition format
                (scrape this; burn-rate gauges and ``deal_health_alerts``
                counters surface SLO state without parsing a trace)
    /healthz    {"status": "ok"|"alerting", "n_alerts", "alerts": [...]}
    /stats      the full ``Session.stats()`` tree as JSON

Reads are point-in-time over the live single-threaded engine: a scrape
racing a serve step can observe a mid-step counter, which is the normal
Prometheus contract (monotonic counters, last-write gauges) — the engine
itself is never blocked or mutated by a scrape.

The snapshot writer appends nothing and rewrites atomically (tmp +
``os.replace``), so a crashed process always leaves a parseable last
snapshot behind for the report CLI.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def json_sanitize(obj):
    """Recursively coerce a stats tree to pure-JSON types (numpy scalars
    and arrays appear throughout the legacy ``stats()`` shapes; torch
    tensors, 0-d ones included, become numbers or nested lists)."""
    import numpy as np
    import torch
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        # tolist() of a 0-d array or tensor is a Python scalar
        return json_sanitize(obj.tolist())
    if isinstance(obj, dict):
        return {str(k): json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (bool, int, str)) or obj is None:
        return obj
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    return str(obj)


class TelemetryEndpoint:
    """Serve /metrics, /healthz and /stats for one ``Session`` and
    (optionally) write periodic JSON snapshots of its stats tree."""

    def __init__(self, session, *, port: int = 0, host: str = "127.0.0.1",
                 snapshot_path: str = "", snapshot_every_s: float = 1.0):
        self.session = session
        self.host = host
        self.want_port = int(port)
        self.snapshot_path = snapshot_path
        self.snapshot_every_s = float(snapshot_every_s)
        self.port: Optional[int] = None     # bound port once started
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads = []
        self._stop = threading.Event()
        self.n_snapshots = 0

    # -- payload builders (also used directly by tests) -----------------
    def _health_doc(self) -> dict:
        eng = getattr(self.session, "_engine", None)
        mon = getattr(eng, "health", None) if eng is not None else None
        summary = mon.summary() if mon is not None else {
            "n_alerts": 0, "alerts": [], "burn_rate": {},
            "wait_burn_rate": {}, "firing": []}
        summary["status"] = "alerting" if summary["firing"] else "ok"
        return json_sanitize(summary)

    def _stats_doc(self) -> dict:
        return json_sanitize(self.session.stats())

    def write_snapshot(self) -> None:
        doc = {"stats": self._stats_doc(), "health": self._health_doc()}
        tmp = f"{self.snapshot_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.snapshot_path)
        self.n_snapshots += 1

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "TelemetryEndpoint":
        if self.want_port >= 0:
            ep = self

            class _Handler(BaseHTTPRequestHandler):
                def log_message(self, *a):   # no stderr chatter per scrape
                    pass

                def do_GET(self):
                    try:
                        if self.path == "/metrics":
                            body = ep.session.prometheus_text().encode()
                            ctype = ("text/plain; version=0.0.4; "
                                     "charset=utf-8")
                        elif self.path == "/healthz":
                            body = json.dumps(
                                ep._health_doc(), sort_keys=True).encode()
                            ctype = "application/json"
                        elif self.path == "/stats":
                            body = json.dumps(
                                ep._stats_doc(), sort_keys=True).encode()
                            ctype = "application/json"
                        else:
                            self.send_error(404)
                            return
                    except Exception as exc:   # surface, don't wedge
                        self.send_error(500, str(exc))
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            self._server = ThreadingHTTPServer((self.host, self.want_port),
                                               _Handler)
            self._server.daemon_threads = True
            self.port = self._server.server_address[1]
            t = threading.Thread(target=self._server.serve_forever,
                                 name="deal-telemetry-http", daemon=True)
            t.start()
            self._threads.append(t)
        if self.snapshot_path:
            t = threading.Thread(target=self._snapshot_loop,
                                 name="deal-telemetry-snapshot",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.snapshot_every_s):
            try:
                self.write_snapshot()
            except Exception:
                # a transient race with close() must not kill the loop;
                # the final snapshot in stop() still runs
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self.snapshot_path:
            try:        # one last consistent snapshot on clean shutdown
                self.write_snapshot()
            except Exception:
                pass


__all__ = ["TelemetryEndpoint", "json_sanitize"]
