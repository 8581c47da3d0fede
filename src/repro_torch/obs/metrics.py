"""Process-global metrics registry: counters, gauges, histograms.

Counters are **always on** — they are plain Python int increments on the
host, with no device work and no numeric effect on any pipeline output,
which is what lets the cache-proof counters (``api.characterize_call_count``,
``hetero.composition_eval_count``, ``sim.sim_eval_count``) and the kernel
dispatch counters live here without an enable flag. Spans
(``repro_torch.obs.trace``) are the gated, timestamp-bearing half.

Naming follows the repo's unit-suffix convention: a metric carrying a
physical unit ends in its suffix (``serve.prefill_s`` is seconds); bare
counts (``hetero.cache_hits``) carry none. The full catalog lives in
``repro_torch.obs.catalog`` and ``docs/OBSERVABILITY_TORCH.md``.

Stdlib-only, thread-safe at the registry level (creation under a lock;
int/float updates ride the GIL).
"""
from __future__ import annotations

import threading
from typing import Dict


class Counter:
    """Monotonic event count."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (e.g. a configured size)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary: count / total / min / max (mean derived)."""
    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Registry:
    """Name → instrument map; ``get-or-create`` accessors are idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            return h

    def value(self, name: str, default: int = 0) -> int:
        """A counter's current value (``default`` if never created)."""
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else default

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain-dict view of every instrument (JSON-ready)."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {
                    n: {"count": h.count, "total": h.total, "min": h.min,
                        "max": h.max, "mean": h.mean}
                    for n, h in self._hists.items()},
            }

    def reset(self) -> None:
        """Zero every instrument, keeping registered names alive (so
        pre-registered catalog metrics still appear in snapshots)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._hists.values():
                h.count, h.total, h.min, h.max = 0, 0.0, None, None


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def value(name: str, default: int = 0) -> int:
    return REGISTRY.value(name, default)


def snapshot() -> Dict[str, Dict[str, object]]:
    return REGISTRY.snapshot()
