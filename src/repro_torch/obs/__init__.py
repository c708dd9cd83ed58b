"""repro_torch.obs — tracing and metrics for the port, the twin of
``repro.obs`` with the same span and metric names at the same sites.

One ``Telemetry`` object pairs a span ``Tracer`` (a ring buffer of
``capacity`` spans over an injectable clock, ``obs.trace``) with a
``MetricsRegistry`` (typed counters / gauges / histograms,
``obs.metrics``).  The exporters turn either into a Perfetto-loadable
trace JSON or a Prometheus text dump (``obs.export``); ``obs.endpoint``
serves them over HTTP, ``obs.validate`` and ``obs.report`` check a
dumped trace.  The serving tier's health and attribution layer is
``obs.health``, the flat metric view of ``Session.stats()`` is
``obs.compat``.

Instrumentation sites call the module-level helpers, so no tracer has to
be threaded through every constructor:

    from repro_torch import obs
    ...
    with obs.span("sample.layer") as sp:
        ...
        if sp:                       # falsy in no-op mode: the attrs
            sp.set(rows=n)           # dict is never built

The process default is a disabled telemetry: every helper is a no-op
whose cost is one attribute check (``tel.enabled``) and which allocates
nothing; ``span`` reads the profiler's enabled flag besides.
``api.Session`` builds a ``Telemetry`` from its config's
``TelemetrySpec`` and ``install``s it for the session's lifetime; tests
use the ``use(tel)`` context manager.

While ``torch.profiler`` records, every span is also a
``record_function`` range of its name, so that the port's stages sit in
the profiler's trace beside the device work they launch, on its clock:

    telemetry   profiler    ``span`` gives
    enabled     recording   the tracer's span and the range (truthy)
    disabled    recording   the range alone (falsy, as ``NOOP_SPAN``)
    disabled    off         ``NOOP_SPAN``

Call sites that synchronize the device to make a span hold its own work
do so only where ``profiling()`` is false: the trace holds the device's
time already, and a synchronize would put idle time into it.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

from torch.autograd import profiler as _profiler

from repro_torch.obs.export import (chrome_trace, dump_chrome_trace,
                                    prometheus_text)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import NOOP_SPAN, FakeClock, NoopSpan, Tracer


class Telemetry:
    """One session's telemetry: enabled flag + tracer + metrics."""

    __slots__ = ("enabled", "tracer", "metrics")

    def __init__(self, enabled: bool = True, clock=None,
                 capacity: int = 65536):
        self.enabled = enabled
        self.tracer = Tracer(clock=clock, capacity=capacity)
        self.metrics = MetricsRegistry()
        # every completed span also feeds a per-name duration histogram
        # (``ops.spmm`` span -> ``ops.spmm_ms``), with a second
        # executor-attributed series when the span carries an
        # ``executor`` attr (``ops.spmm.cuda_ms``)
        self.tracer.on_record = self._span_metric

    def _span_metric(self, name, dur_ns, attrs) -> None:
        ms = dur_ns / 1e6
        self.metrics.histogram(name + "_ms").observe(ms)
        if attrs:
            ex = attrs.get("executor")
            if ex:
                self.metrics.histogram(f"{name}.{ex}_ms").observe(ms)

    @property
    def counters(self) -> Dict[str, float]:
        """The counters' values by name."""
        return {m.name: m.value for m in self.metrics if m.kind == "counter"}

    # -- spans ----------------------------------------------------------
    def span(self, name: str, attrs: Optional[dict] = None):
        if not self.enabled:
            if _profiler._is_profiler_enabled:
                return _Range(None, name)
            return NOOP_SPAN
        sp = self.tracer.span(name, attrs)
        if _profiler._is_profiler_enabled:
            return _Range(sp, name)
        return sp

    # -- metrics --------------------------------------------------------
    def add(self, name: str, v: float = 1.0) -> None:
        if self.enabled:
            self.metrics.counter(name).inc(v)

    def gauge(self, name: str, v: float) -> None:
        if self.enabled:
            self.metrics.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        if self.enabled:
            self.metrics.histogram(name).observe(v)

    def now_ns(self) -> int:
        return self.tracer.clock()

    def clear(self) -> None:
        self.tracer.clear()
        self.metrics.clear()


class _Range:
    """A span while ``torch.profiler`` records: a ``record_function``
    range of the span's name around the tracer's span ``sp``, or around
    nothing where telemetry is disabled (then falsy, as ``NOOP_SPAN``,
    so that call sites skip their attrs)."""

    __slots__ = ("_sp", "_rf")

    def __init__(self, sp, name: str):
        self._sp = sp
        self._rf = _profiler.record_function(name)

    def __enter__(self) -> "_Range":
        self._rf.__enter__()
        if self._sp is not None:
            self._sp.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sp is not None:
            self._sp.__exit__(*exc)
        self._rf.__exit__(*exc)
        return False

    def __bool__(self) -> bool:
        return self._sp is not None

    def set(self, **attrs) -> None:
        if self._sp is not None:
            self._sp.set(**attrs)


def profiling() -> bool:
    """True while ``torch.profiler`` records: spans are then its ranges
    too, and no span synchronizes the device."""
    return _profiler._is_profiler_enabled


DISABLED = Telemetry(enabled=False, capacity=1)
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


# -- module-level hot-path helpers (one attribute check, no allocation
#    when disabled) -------------------------------------------------------

def span(name: str, attrs: Optional[dict] = None):
    return _CURRENT.span(name, attrs)


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


__all__ = ["Telemetry", "Tracer", "FakeClock", "MetricsRegistry",
           "Counter", "Gauge", "Histogram", "NoopSpan", "NOOP_SPAN",
           "DISABLED", "chrome_trace", "dump_chrome_trace",
           "prometheus_text", "current", "enabled", "install", "use",
           "span", "add", "gauge", "observe", "profiling"]
