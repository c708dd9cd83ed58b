"""Typed counters / gauges / histograms in one named registry — the
port's copy of ``repro.obs.metrics``, with the same names:

    store.evictions                 counter
    store.recompute_ms              histogram (per outermost recompute)
    delta.frontier_rows             counter
    qos.tenant.<name>.wait_ms       histogram
    serve.gather_ms                 histogram

Metrics are get-or-create by name and strictly typed: re-registering a
name as a different kind raises.  Histograms keep exact
count/sum/min/max plus a bounded sample window (newest ``MAX_SAMPLES``
observations) for p50/p95 without O(observations) memory.
"""
from __future__ import annotations

from typing import Dict, List, Union

MAX_SAMPLES = 4096


class Counter:
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("name", "count", "total", "vmin", "vmax", "samples")
    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.samples.append(v)
        if len(self.samples) > MAX_SAMPLES:
            del self.samples[:len(self.samples) - MAX_SAMPLES]

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        # nearest-rank on the retained window (deterministic, no numpy)
        idx = min(int(round(q / 100.0 * (len(s) - 1))), len(s) - 1)
        return s[idx]

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count, "min": self.vmin,
                "max": self.vmax, "p50": self.percentile(50),
                "p95": self.percentile(95)}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named metrics, get-or-create, strictly typed per name."""

    def __init__(self):
        self._m: Dict[str, Metric] = {}

    def _get(self, name: str, cls) -> Metric:
        m = self._m.get(name)
        if m is None:
            m = cls(name)
            self._m[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def __contains__(self, name: str) -> bool:
        return name in self._m

    def __iter__(self):
        return iter(self._m.values())

    def __len__(self) -> int:
        return len(self._m)

    def clear(self) -> None:
        self._m.clear()

    def to_dict(self) -> Dict[str, float]:
        """Flat name -> value view (sorted).  Histograms expand into
        ``<name>.count / .sum / .mean / .min / .max / .p50 / .p95``."""
        out: Dict[str, float] = {}
        for name in sorted(self._m):
            m = self._m[name]
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        return out
