"""Serving-tier health: per-query critical-path attribution and SLO
burn-rate monitoring — the port's copy of ``repro.obs.health``.

Two cooperating pieces, both fed by ``gnnserve.engine`` only when
telemetry is enabled (the engine's hooks all guard on a per-query
``attrib`` dict / a lazily-built monitor, so the disabled cost stays
zero):

``AttributionCollector``
    Every served query's wall time, partitioned into the causal
    segments of its critical path —

        queue_wait      submit -> slot admission (+ re-queues after a
                        preemption or a mid-job park)
        pin             snapshot pinning (admit-then-capture) minus the
                        recompute share
        recompute       recompute-on-miss time triggered by the pin
        gather          this query's row-proportional share of the
                        fused sharded gathers it rode
        refresh_wait    refresh interference: inline refreshes and
                        chunked-refresh chunk advances that ran during
                        steps the query sat in a slot
        sched_wait      the rest of the in-slot time — waiting for DRR
                        grants / other tenants' rows

    The segments partition ``[submit, done]``: queue_wait + in-slot
    time are measured from the same clock reads that bound the query's
    end-to-end wall time, so the per-tenant sums reconcile against
    measured e2e (the acceptance bound is 5%; ``summary()`` reports the
    ``attributed_frac`` per tenant).  The engine also records one
    ``serve.query`` trace event per completed query (own Perfetto
    track, segment attrs) — the report CLI's top-k critical paths.

``HealthMonitor``
    Rolling-window detectors emitting structured ``health.alert``
    events into the trace plus ``health.alerts[.<kind>]`` counters and
    ``health.burn_rate.<tenant>`` gauges (so alerts surface on the
    Prometheus endpoint too).  Detectors:

    * ``slo_burn`` — per-tenant burn rate over the staleness SLO:
      ``burn = violating_fraction_of_window / error_budget``; fires at
      ``burn >= burn_threshold``, re-arms below half the threshold
      (hysteresis, so a sustained burn alerts once, not per step).
    * ``wait_burn`` — same machinery over queue wait vs an optional
      wall-clock wait SLO (``wait_slo_ms``; 0 disables).
    * ``evict_thrash`` — eviction events over the last window exceed
      ``thrash_evictions`` (the budgeted store is churning rows it is
      about to need again).
    * ``refresh_backlog`` — pending mutations grew across the window
      AND exceed ``backlog_factor`` x the tightest tenant SLO: refresh
      is not keeping up with the mutation stream.
    * ``route_flap`` — the dist-vs-local refresh route (the frontier
      cutover of the distributed executor, ``refresh.dist_local_cutover``)
      flipped direction >= ``flap_threshold`` times within the window:
      frontier sizes are hovering at the cutover and every flip pays a
      cold plan or a cold mesh dispatch.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from repro_torch import obs

# the canonical segment order (reports render in this order)
SEGMENTS = ("queue_wait", "pin", "recompute", "gather", "refresh_wait",
            "sched_wait")

MAX_SAMPLES = 4096


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q / 100.0 * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]


class _TenantAttrib:
    __slots__ = ("n", "e2e_sum", "seg_sum", "e2e_samples")

    def __init__(self):
        self.n = 0
        self.e2e_sum = 0
        self.seg_sum = {s: 0 for s in SEGMENTS}
        self.e2e_samples: List[int] = []


class AttributionCollector:
    """Per-tenant aggregation of per-query critical-path segments,
    plus a bounded top-k of the slowest individual queries."""

    def __init__(self, top_k: int = 16):
        self.top_k = int(top_k)
        self._t: Dict[str, _TenantAttrib] = {}
        self._top: List[dict] = []      # sorted by e2e_ns desc

    def record(self, *, uid: int, tenant: str, e2e_ns: int,
               segments_ns: Dict[str, int],
               served_version: int = -1) -> None:
        t = self._t.get(tenant)
        if t is None:
            t = self._t[tenant] = _TenantAttrib()
        t.n += 1
        t.e2e_sum += int(e2e_ns)
        for s in SEGMENTS:
            t.seg_sum[s] += int(segments_ns.get(s, 0))
        t.e2e_samples.append(int(e2e_ns))
        if len(t.e2e_samples) > MAX_SAMPLES:
            del t.e2e_samples[:len(t.e2e_samples) - MAX_SAMPLES]
        if (len(self._top) < self.top_k
                or e2e_ns > self._top[-1]["e2e_ns"]):
            self._top.append({"uid": int(uid), "tenant": tenant,
                              "e2e_ns": int(e2e_ns),
                              "served_version": int(served_version),
                              "segments_ns": {s: int(segments_ns.get(s, 0))
                                              for s in SEGMENTS}})
            self._top.sort(key=lambda r: -r["e2e_ns"])
            del self._top[self.top_k:]

    @property
    def n_queries(self) -> int:
        return sum(t.n for t in self._t.values())

    def summary(self) -> Dict[str, dict]:
        """Per tenant: query count, e2e latency stats, per-segment
        totals + fractions, and the attribution closure
        (``attributed_frac`` = segment sum / measured e2e sum — the 5%
        reconciliation bound means this stays within [0.95, 1.05])."""
        out: Dict[str, dict] = {}
        for name, t in sorted(self._t.items()):
            samples = sorted(t.e2e_samples)
            seg_total = sum(t.seg_sum.values())
            e2e = max(t.e2e_sum, 1)
            out[name] = {
                "n_queries": t.n,
                "e2e_ms": {
                    "sum": t.e2e_sum / 1e6,
                    "mean": t.e2e_sum / max(t.n, 1) / 1e6,
                    "p50": _pct(samples, 50) / 1e6,
                    "p95": _pct(samples, 95) / 1e6,
                    "max": (samples[-1] if samples else 0) / 1e6,
                },
                "segments_ms": {s: t.seg_sum[s] / 1e6 for s in SEGMENTS},
                "segments_frac": {s: t.seg_sum[s] / e2e for s in SEGMENTS},
                "attributed_frac": seg_total / e2e,
            }
        return out

    def top_paths(self) -> List[dict]:
        """The slowest queries, worst first, with segment breakdowns in
        ms (the report CLI's top-k critical-path table)."""
        return [{"uid": r["uid"], "tenant": r["tenant"],
                 "served_version": r["served_version"],
                 "e2e_ms": r["e2e_ns"] / 1e6,
                 "segments_ms": {s: v / 1e6
                                 for s, v in r["segments_ns"].items()}}
                for r in self._top]


class HealthMonitor:
    """Rolling-window SLO burn-rate + serving-health detectors (see the
    module docstring).  ``slos`` maps tenant name -> staleness SLO (the
    engine passes its QoS registry, or ``{"default": staleness_bound}``
    on the FIFO path)."""

    def __init__(self, slos: Dict[str, int], *, window: int = 128,
                 error_budget: float = 0.01, burn_threshold: float = 4.0,
                 wait_slo_ms: float = 0.0, thrash_evictions: int = 32,
                 backlog_factor: float = 4.0, flap_threshold: int = 8):
        assert slos, "at least one tenant SLO required"
        assert window >= 2 and 0 < error_budget <= 1 and burn_threshold > 0
        self.slos = {k: int(v) for k, v in slos.items()}
        self.window = int(window)
        self.error_budget = float(error_budget)
        self.burn_threshold = float(burn_threshold)
        self.wait_slo_ms = float(wait_slo_ms)
        self.thrash_evictions = int(thrash_evictions)
        self.backlog_factor = float(backlog_factor)
        self.flap_threshold = int(flap_threshold)
        self.alerts: List[dict] = []
        self.burn_rate: Dict[str, float] = {}
        self.wait_burn_rate: Dict[str, float] = {}
        self.step_no = 0
        self._stale: Dict[str, deque] = {}
        self._wait: Dict[str, deque] = {}
        self._firing: set = set()       # (kind, subject) with hysteresis
        self._pending: deque = deque(maxlen=self.window)
        self._evict: deque = deque(maxlen=self.window)
        # counter baselines prime on the FIRST on_step: the monitor can
        # attach to a warm engine without reading its whole history as
        # one burst
        self._last: Optional[Dict[str, int]] = None
        self._route_dir = 0
        self._flips: deque = deque(maxlen=self.window)

    # -- alert plumbing -------------------------------------------------
    def _fire(self, kind: str, subject: str, details: dict) -> None:
        key = (kind, subject)
        if key in self._firing:
            return
        self._firing.add(key)
        alert = {"kind": kind, "subject": subject, "step": self.step_no,
                 **details}
        self.alerts.append(alert)
        obs.add("health.alerts")
        obs.add(f"health.alerts.{kind}")
        tel = obs.current()
        if tel.enabled:
            # a zero-duration structured event in the span stream: the
            # report CLI and Perfetto both see WHEN the alert fired
            tel.tracer.record("health.alert", tel.now_ns(), 0, 0,
                              dict(alert))

    def _clear(self, kind: str, subject: str) -> None:
        self._firing.discard((kind, subject))

    # -- per-observation feeds ------------------------------------------
    def _burn(self, dq: deque, violated: bool, budget: float) -> float:
        dq.append(1 if violated else 0)
        return (sum(dq) / len(dq)) / budget

    def on_staleness(self, tenant: str, staleness: int) -> None:
        """One pinned read's observed staleness vs the tenant's SLO."""
        slo = self.slos.get(tenant)
        if slo is None:
            return
        dq = self._stale.get(tenant)
        if dq is None:
            dq = self._stale[tenant] = deque(maxlen=self.window)
        burn = self._burn(dq, staleness > slo, self.error_budget)
        self.burn_rate[tenant] = burn
        obs.gauge(f"health.burn_rate.{tenant}", burn)
        if burn >= self.burn_threshold:
            self._fire("slo_burn", tenant,
                       {"burn_rate": round(burn, 3), "slo": slo,
                        "window": len(dq), "violations": int(sum(dq))})
        elif burn < self.burn_threshold / 2:
            self._clear("slo_burn", tenant)

    def on_wait(self, tenant: str, wait_ms: float) -> None:
        """One query's queue wait vs the (optional) wall-clock wait
        SLO."""
        if self.wait_slo_ms <= 0:
            return
        dq = self._wait.get(tenant)
        if dq is None:
            dq = self._wait[tenant] = deque(maxlen=self.window)
        burn = self._burn(dq, wait_ms > self.wait_slo_ms,
                          self.error_budget)
        self.wait_burn_rate[tenant] = burn
        obs.gauge(f"health.wait_burn_rate.{tenant}", burn)
        if burn >= self.burn_threshold:
            self._fire("wait_burn", tenant,
                       {"burn_rate": round(burn, 3),
                        "wait_slo_ms": self.wait_slo_ms,
                        "window": len(dq), "violations": int(sum(dq))})
        elif burn < self.burn_threshold / 2:
            self._clear("wait_burn", tenant)

    def on_step(self, *, pending: int, evictions: int,
                route_local: int = 0, route_dist: int = 0) -> None:
        """One engine step's cumulative counters (the monitor diffs
        them; a counter moving backwards — e.g. a ``full_epoch`` store
        swap — resets that detector's baseline)."""
        self.step_no += 1
        if self._last is None:           # prime the diff baselines
            self._last = {"evictions": int(evictions),
                          "route_local": int(route_local),
                          "route_dist": int(route_dist)}

        # refresh-backlog growth: pending grew across the window AND
        # exceeds what the tightest SLO should ever let accumulate
        self._pending.append(int(pending))
        tight = min(self.slos.values())
        cap = self.backlog_factor * max(tight, 1)
        if (len(self._pending) == self._pending.maxlen
                and pending > self._pending[0] and pending >= cap):
            self._fire("refresh_backlog", "engine",
                       {"pending": int(pending),
                        "window_ago": int(self._pending[0]),
                        "cap": cap})
        elif pending <= max(tight, 1):
            self._clear("refresh_backlog", "engine")

        # eviction thrash: eviction events per rolling window
        d_ev = max(int(evictions) - self._last["evictions"], 0)
        self._last["evictions"] = int(evictions)
        self._evict.append(d_ev)
        ev_window = sum(self._evict)
        if ev_window >= self.thrash_evictions:
            self._fire("evict_thrash", "store",
                       {"evictions_in_window": int(ev_window),
                        "window": len(self._evict)})
        elif ev_window < self.thrash_evictions / 2:
            self._clear("evict_thrash", "store")

        # route flapping: dist-vs-local refresh routing changed
        # direction repeatedly within the window
        d_l = max(int(route_local) - self._last["route_local"], 0)
        d_d = max(int(route_dist) - self._last["route_dist"], 0)
        self._last["route_local"] = int(route_local)
        self._last["route_dist"] = int(route_dist)
        direction = 1 if (d_l and not d_d) else (-1 if (d_d and not d_l)
                                                 else 0)
        if direction and self._route_dir and direction != self._route_dir:
            self._flips.append(self.step_no)
        if direction:
            self._route_dir = direction
        flips = sum(1 for s in self._flips
                    if s > self.step_no - self.window)
        if flips >= self.flap_threshold:
            self._fire("route_flap", "refresh",
                       {"flips_in_window": int(flips),
                        "window": self.window})
        elif flips < self.flap_threshold / 2:
            self._clear("route_flap", "refresh")

    def summary(self) -> dict:
        return {"n_alerts": len(self.alerts),
                "alerts": list(self.alerts),
                "burn_rate": dict(self.burn_rate),
                "wait_burn_rate": dict(self.wait_burn_rate),
                "firing": sorted(f"{k}:{s}" for k, s in self._firing)}


__all__ = ["SEGMENTS", "AttributionCollector", "HealthMonitor"]
