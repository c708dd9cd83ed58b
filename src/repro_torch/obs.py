"""Spans and counters for the port — the no-op-unless-enabled core of
``repro.obs`` (``span`` / ``add`` / ``enabled``), with the same span
names at the same sites.  Exporters, histograms and the health layer
are not ported yet.

The process default is a disabled telemetry: ``span`` returns a falsy
shared no-op span after one attribute check, so call sites write

    with obs.span("sample.layer") as sp:
        ...
        if sp:
            sp.set(rows=n)
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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
        tel.events.append((self.name, self._t0, t1 - self._t0,
                           self._depth, self.attrs))
        return False

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)


class Telemetry:
    """One session's spans (kept in order of completion) and counters."""

    def __init__(self, enabled: bool = True, clock=None):
        self.enabled = enabled
        self.clock = clock if clock is not None else time.perf_counter_ns
        self.events: List[SpanTuple] = []
        self.counters: Dict[str, float] = {}
        self.depth = 0


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


def span(name: str, attrs: Optional[dict] = None):
    tel = _CURRENT
    if not tel.enabled:
        return NOOP_SPAN
    return _Span(tel, name, attrs)


def add(name: str, v: float = 1.0) -> None:
    tel = _CURRENT
    if tel.enabled:
        tel.counters[name] = tel.counters.get(name, 0.0) + v
