"""Typed metrics — counters, gauges, bounded histograms, one registry (port
of ``repro.obs.metrics``).

The numeric half of ``repro_torch.obs``: spans attribute WHERE time went, these
attribute HOW MUCH (pairs collected, bytes transferred, retries taken,
latency distributions).  Every metric serializes through one
``to_dict()`` schema so ``TraceReport.metrics()`` and the Chrome-trace
``"repro"`` blob speak the reference's dialect:

    counter    {"type": "counter",   "value": <number>}
    gauge      {"type": "gauge",     "value": <number>}
    histogram  {"type": "histogram", "count": n, "p50": ..., "p95": ...,
                "mean": ..., "max": ...}

``Histogram`` is a fixed-capacity numpy ring buffer (the last ``capacity``
observations — a sliding window, NOT a lossy sketch), so long-lived
accumulators (the serve latency window, per-chunk commit latencies) hold
O(capacity) floats forever instead of growing per request.  Percentiles
use nearest-rank-below semantics — ``sorted[min(n-1, int(p*(n-1)))]`` —
deliberately identical to the historical ``ServeStats`` deque math so
swapping the serve window onto this type changes no reported number.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import numpy as np

Number = Union[int, float]


class Counter:
    """Monotonically increasing count (pairs, bytes, retries)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        """Add ``n`` (default 1) to the count."""
        self.value += n

    def to_dict(self) -> dict:
        """The unified metric schema entry for this counter."""
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar (current pair-set size, imbalance ratio)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        """Record ``v`` as the gauge's current value."""
        self.value = v

    def to_dict(self) -> dict:
        """The unified metric schema entry for this gauge."""
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Bounded sliding-window distribution over the LAST ``capacity``
    observations (preallocated numpy ring buffer — no per-observation
    Python objects, no unbounded growth).

    ``count`` is the lifetime observation total; ``percentile``/``mean``/
    ``max`` summarize the current window.  Percentile semantics match the
    pre-obs ServeStats deque exactly: sort the window, index
    ``min(n-1, int(p*(n-1)))``."""
    __slots__ = ("name", "capacity", "_buf", "_n")

    def __init__(self, name: str, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, np.float64)
        self._n = 0

    def observe(self, v: Number) -> None:
        """Record one observation (evicting the oldest once the window is
        full)."""
        self._buf[self._n % self.capacity] = v
        self._n += 1

    @property
    def count(self) -> int:
        """Lifetime observations (may exceed the window capacity)."""
        return self._n

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def window(self) -> np.ndarray:
        """The current window's values (order not meaningful)."""
        return self._buf[:min(self._n, self.capacity)].copy()

    def percentile(self, p: float) -> float:
        """Window percentile with the historical serve-window semantics:
        ``sorted[min(n-1, int(p*(n-1)))]``; 0.0 on an empty window."""
        w = np.sort(self._buf[:min(self._n, self.capacity)])
        if w.size == 0:
            return 0.0
        return float(w[min(w.size - 1, int(p * (w.size - 1)))])

    def to_dict(self) -> dict:
        """The unified metric schema entry: lifetime count + window
        p50/p95/mean/max."""
        w = self._buf[:min(self._n, self.capacity)]
        if w.size == 0:
            return {"type": "histogram", "count": 0, "p50": 0.0,
                    "p95": 0.0, "mean": 0.0, "max": 0.0}
        return {"type": "histogram", "count": self._n,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "mean": float(w.mean()), "max": float(w.max())}


class MetricsRegistry:
    """Get-or-create store of named metrics with one ``to_dict()`` export.

    Creation is lock-protected (tracers are shared across threads);
    re-requesting a name returns the existing metric, and re-requesting it
    AS A DIFFERENT TYPE raises — a silent counter/gauge aliasing bug would
    corrupt every downstream report."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        """Get or create the counter named ``name``."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get or create the gauge named ``name``."""
        return self._get(name, Gauge)

    def histogram(self, name: str, capacity: int = 2048) -> Histogram:
        """Get or create the histogram named ``name`` (``capacity`` only
        applies on first creation)."""
        return self._get(name, Histogram, capacity)

    def __len__(self) -> int:
        return len(self._metrics)

    def to_dict(self) -> dict:
        """Every registered metric through the unified schema, keyed by
        name (insertion-ordered)."""
        with self._lock:
            return {k: m.to_dict() for k, m in self._metrics.items()}
