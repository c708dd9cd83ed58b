"""Spans and metrics for the port — the no-op-unless-enabled core of
``repro.obs`` (``span`` / ``add`` / ``gauge`` / ``observe`` /
``enabled``), with the same span and metric names at the same sites.
Counters, gauges and histograms live in one ``metrics.MetricsRegistry``
(``Telemetry.metrics``); the serving tier's health and attribution
layer is ``obs.health``, the flat metric view of ``Session.stats()`` is
``obs.compat``.  The exporters and the scrape endpoint are not ported
yet (ROADMAP Queue 1 item 7).

The process default is a disabled telemetry: ``span`` returns a falsy
shared no-op span after one attribute check, so call sites write

    with obs.span("sample.layer") as sp:
        ...
        if sp:
            sp.set(rows=n)
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry

# one recorded span: (name, t_start_ns, dur_ns, depth, attrs-or-None)
SpanTuple = Tuple[str, int, int, int, Optional[dict]]


class FakeClock:
    """Deterministic test clock: every read advances by ``step`` ns."""

    def __init__(self, start: int = 0, step: int = 1000):
        self.t = int(start)
        self.step = int(step)

    def __call__(self) -> int:
        t = self.t
        self.t += self.step
        return t


class NoopSpan:
    """Shared do-nothing span; falsy so call sites skip building attrs."""

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
    __slots__ = ("_tel", "name", "attrs", "_t0", "_depth")

    def __init__(self, tel: "Telemetry", name: str, attrs: Optional[dict]):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self._depth = self._tel.depth
        self._tel.depth += 1
        self._t0 = self._tel.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tel = self._tel
        t1 = tel.clock()
        tel.depth -= 1
        tel.record(self.name, self._t0, t1 - self._t0, self._depth,
                   self.attrs)
        return False

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)


class Telemetry:
    """One session's spans (kept in order of completion) and metrics."""

    def __init__(self, enabled: bool = True, clock=None):
        self.enabled = enabled
        self.clock = clock if clock is not None else time.perf_counter_ns
        self.events: List[SpanTuple] = []
        self.metrics = MetricsRegistry()
        self.depth = 0

    @property
    def counters(self) -> Dict[str, float]:
        """The counters' values by name."""
        return {m.name: m.value for m in self.metrics if m.kind == "counter"}

    def now_ns(self) -> int:
        return self.clock()

    def record(self, name: str, t0: int, dur: int, depth: int,
               attrs: Optional[dict]) -> None:
        """Append one completed span (instrumentation that already
        measured an interval, or a zero-duration event).  As in
        ``repro.obs``, every span also feeds a ``<name>_ms`` histogram,
        and a ``<name>.<executor>_ms`` one when it names an executor."""
        self.events.append((name, int(t0), int(dur), int(depth), attrs))
        ms = dur / 1e6
        self.metrics.histogram(name + "_ms").observe(ms)
        if attrs and attrs.get("executor"):
            self.metrics.histogram(
                f"{name}.{attrs['executor']}_ms").observe(ms)


DISABLED = Telemetry(enabled=False)
_CURRENT: Telemetry = DISABLED


def current() -> Telemetry:
    return _CURRENT


def enabled() -> bool:
    return _CURRENT.enabled


def install(tel: Optional[Telemetry]) -> Telemetry:
    """Make ``tel`` the process-current telemetry (None -> disabled);
    returns the previous one so callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tel if tel is not None else DISABLED
    return prev


@contextmanager
def use(tel: Optional[Telemetry]):
    """Scoped ``install`` (tests)."""
    prev = install(tel)
    try:
        yield tel
    finally:
        install(prev)


def span(name: str, attrs: Optional[dict] = None):
    tel = _CURRENT
    if not tel.enabled:
        return NOOP_SPAN
    return _Span(tel, name, attrs)


def add(name: str, v: float = 1.0) -> None:
    tel = _CURRENT
    if tel.enabled:
        tel.metrics.counter(name).inc(v)


def gauge(name: str, v: float) -> None:
    tel = _CURRENT
    if tel.enabled:
        tel.metrics.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    tel = _CURRENT
    if tel.enabled:
        tel.metrics.histogram(name).observe(v)
