"""Nestable tracing spans over an injectable monotonic clock — the
port's copy of ``repro.obs.trace``, with the same ring buffer.

The pipeline's perf story (sampling vs feature prep vs per-layer ops vs
comms vs refresh vs eviction) needs *stage-level* evidence, not one
end-to-end wall clock.  A ``Tracer`` records completed spans —

    with tracer.span("refresh.frontier") as sp:
        ...
        sp.set(rows=int(n))          # attach attrs once known

— into a fixed-capacity ring buffer (oldest spans drop first, counted in
``n_dropped``, so a long-lived serving process never grows unbounded).
Spans nest: the tracer tracks the live depth, so exporters can rebuild
the flame graph without parent pointers.

Clock: any zero-arg callable returning integer NANOSECONDS.  The default
is ``time.perf_counter_ns`` (monotonic); tests inject ``FakeClock`` so
span layout is bit-for-bit deterministic (golden exporter files).

The no-op story lives one level up (``obs.Telemetry.span`` /
``obs.span``): when telemetry is disabled those return the shared
``NOOP_SPAN`` singleton after a single attribute check — no ``_Span``
allocation, no clock read, nothing recorded.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

# one recorded span: (name, t_start_ns, dur_ns, depth, attrs-or-None)
SpanTuple = Tuple[str, int, int, int, Optional[dict]]


class FakeClock:
    """Deterministic test clock: every read advances by ``step`` ns, so
    a span's duration equals ``step * (clock reads inside it)``."""

    def __init__(self, start: int = 0, step: int = 1000):
        self.t = int(start)
        self.step = int(step)

    def __call__(self) -> int:
        t = self.t
        self.t += self.step
        return t

    def advance(self, ns: int) -> None:
        self.t += int(ns)


class NoopSpan:
    """Shared do-nothing span; falsy so call sites can skip building
    attrs dicts entirely (``if sp: sp.set(...)``)."""

    __slots__ = ()

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = NoopSpan()


class _Span:
    __slots__ = ("_tr", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self._tr = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        tr = self._tr
        self._depth = tr.depth
        tr.depth += 1
        self._t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        t1 = tr.clock()
        tr.depth -= 1
        tr.record(self.name, self._t0, t1 - self._t0, self._depth,
                  self.attrs)
        return False

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)


class Tracer:
    """Span recorder with a bounded ring buffer.

    Spans are recorded at EXIT (start + duration), so ``events`` is
    ordered by end time — exactly what the Chrome/Perfetto trace-event
    format wants (``ph: "X"`` complete events, order irrelevant)."""

    def __init__(self, clock=None, capacity: int = 65536):
        assert capacity > 0
        self.clock = clock if clock is not None else time.perf_counter_ns
        self.capacity = int(capacity)
        self.events: List[SpanTuple] = []
        self._next = 0              # ring write index once full
        self.n_dropped = 0
        self.depth = 0              # live nesting depth
        # optional (name, dur_ns, attrs) callback on every completed
        # span — ``obs.Telemetry`` feeds per-span-name ``_ms`` histograms
        # through it
        self.on_record = None

    def span(self, name: str, attrs: Optional[dict] = None) -> _Span:
        return _Span(self, name, attrs)

    def record(self, name: str, t0: int, dur: int, depth: int,
               attrs: Optional[dict]) -> None:
        """Append one completed span (public so instrumentation that
        already measured an interval can log it without re-timing)."""
        ev = (name, int(t0), int(dur), int(depth), attrs)
        if len(self.events) < self.capacity:
            self.events.append(ev)
        else:
            self.events[self._next] = ev
            self._next = (self._next + 1) % self.capacity
            self.n_dropped += 1
        if self.on_record is not None:
            self.on_record(name, dur, attrs)

    def clear(self) -> None:
        self.events = []
        self._next = 0
        self.n_dropped = 0

    def events_in_order(self) -> List[SpanTuple]:
        """Events oldest-first (unwraps the ring)."""
        if len(self.events) < self.capacity or self._next == 0:
            return list(self.events)
        return self.events[self._next:] + self.events[:self._next]

    # -- analytics (stage breakdowns, coverage) -------------------------
    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """Per span name: call count, total/max duration in ms — the
        stage breakdown the bench JSON summaries report."""
        out: Dict[str, Dict[str, float]] = {}
        for name, _t0, dur, _d, _a in self.events:
            agg = out.setdefault(name, {"count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
            agg["count"] += 1
            ms = dur / 1e6
            agg["total_ms"] += ms
            agg["max_ms"] = max(agg["max_ms"], ms)
        return out

    def window_ns(self) -> Tuple[int, int]:
        """(earliest start, latest end) over recorded spans."""
        if not self.events:
            return (0, 0)
        lo = min(t0 for _n, t0, _d, _dep, _a in self.events)
        hi = max(t0 + d for _n, t0, d, _dep, _a in self.events)
        return (lo, hi)

    def covered_ns(self) -> int:
        """Total ns covered by the UNION of all recorded spans — the
        numerator of the trace-coverage acceptance check (spans must
        account for >= 90% of the traced window)."""
        if not self.events:
            return 0
        iv = sorted((t0, t0 + d) for _n, t0, d, _dep, _a in self.events)
        total = 0
        cur_lo, cur_hi = iv[0]
        for lo, hi in iv[1:]:
            if lo > cur_hi:
                total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        return total + (cur_hi - cur_lo)

    def coverage(self) -> float:
        """Covered fraction of the traced window (0..1)."""
        lo, hi = self.window_ns()
        return self.covered_ns() / max(hi - lo, 1)
