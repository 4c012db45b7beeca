"""Serving metrics registry: counters, gauges, and histograms with a
no-op fast path.

The serving scheduler records every host-side decision (dispatch
counts, wall time around device dispatches, prefix-cache hits, pool
occupancy) through a ``MetricsRegistry``.  Instruments are created on
demand by name so the instrumented code never declares schemas up
front; the null variants make ``record(...)`` calls free when
observability is off (a single attribute load + no-op call — no dict
lookups, no branches at the call site).

Everything here is host-only python over scalars: no torch imports, no
device values.  Values recorded from the serving loop are plain ints /
floats read AFTER ``torch.cuda.synchronize()`` — never tensors — so the
registry can never introduce a device sync (the transfer-free span
contract, see runtime/server.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NullCounter", "NullGauge", "NullHistogram", "NullMetricsRegistry",
    "NULL_METRICS",
]


class Counter:
    """Monotonically-increasing count (dispatches, hits, stalls)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written level plus its observed peak (pool occupancy)."""

    __slots__ = ("name", "value", "peak", "samples")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.peak = -math.inf
        self.samples = 0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v
        self.samples += 1

    def snapshot(self):
        return {"value": self.value,
                "peak": self.peak if self.samples else 0.0,
                "samples": self.samples}


class Histogram:
    """Streaming summary of observed values (wall times, occupancy).

    Keeps count/total/min/max/sum-of-squares plus the raw samples (the
    serving runs this instruments are sized at thousands of dispatches,
    so exact percentiles are cheaper than sketch bookkeeping; callers
    needing bounded memory can pass ``keep_samples=False``).
    """

    __slots__ = ("name", "count", "total", "min", "max", "_sumsq",
                 "samples", "_keep")

    def __init__(self, name: str, keep_samples: bool = True):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sumsq = 0.0
        self._keep = keep_samples
        self.samples: List[float] = []

    def record(self, v: float) -> None:
        self.count += 1
        self.total += v
        self._sumsq += v * v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if self._keep:
            self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the kept samples; 0.0 empty."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        rank = max(1, math.ceil(q / 100.0 * len(xs)))
        return xs[min(rank, len(xs)) - 1]

    def snapshot(self):
        out = {"count": self.count, "total": self.total,
               "mean": self.mean,
               "min": self.min if self.count else 0.0,
               "max": self.max if self.count else 0.0}
        if self.samples:
            for q in (50, 95, 99):
                out[f"p{q}"] = self.percentile(q)
        return out


class MetricsRegistry:
    """Name-addressed instruments, created on first touch."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- instrument accessors (create on demand) -----------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, keep_samples: bool = True) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, keep_samples)
        return h

    # -- lifecycle ------------------------------------------------------
    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    def snapshot(self) -> Dict[str, dict]:
        return {
            "counters": {k: c.snapshot()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.snapshot()
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._hists.items())},
        }

    # convenience reads used by the serving stats dict ------------------
    def counter_value(self, name: str, default: int = 0) -> int:
        c = self._counters.get(name)
        return c.value if c is not None else default

    def hist_total(self, name: str, default: float = 0.0) -> float:
        h = self._hists.get(name)
        return h.total if h is not None else default

    def hist(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)


# ---------------------------------------------------------------------------
# No-op variants: observability off costs one attribute load per site.

class NullCounter:
    __slots__ = ()
    name = ""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def snapshot(self):
        return 0


class NullGauge:
    __slots__ = ()
    name = ""
    value = 0.0
    peak = 0.0
    samples = 0

    def set(self, v: float) -> None:
        pass

    def snapshot(self):
        return {"value": 0.0, "peak": 0.0, "samples": 0}


class NullHistogram:
    __slots__ = ()
    name = ""
    count = 0
    total = 0.0
    min = 0.0
    max = 0.0
    mean = 0.0
    samples: List[float] = []

    def record(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def snapshot(self):
        return {"count": 0, "total": 0.0, "mean": 0.0,
                "min": 0.0, "max": 0.0}


_NULL_COUNTER = NullCounter()
_NULL_GAUGE = NullGauge()
_NULL_HIST = NullHistogram()


class NullMetricsRegistry:
    """Registry whose instruments are shared no-ops."""

    def counter(self, name: str) -> NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str) -> NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str, keep_samples: bool = True
                  ) -> NullHistogram:
        return _NULL_HIST

    def reset(self) -> None:
        pass

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def counter_value(self, name: str, default: int = 0) -> int:
        return default

    def hist_total(self, name: str, default: float = 0.0) -> float:
        return default

    def hist(self, name: str):
        return None


NULL_METRICS = NullMetricsRegistry()
