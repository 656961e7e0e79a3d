"""Metrics registry: counters / gauges / histograms for the measured
path (DESIGN.md §12; a copy of ``repro/obs/metrics.py`` without its
JAX timing helper).

Deliberately tiny and dependency-free: the registry is
host-side bookkeeping that the train loop, serve loop, and benchmarks
update between dispatches.  Labels are encoded in the metric name
(``comm_bytes.allreduce.flat.post``) — a flat namespace keeps
``snapshot()`` a plain JSON-ready dict that the event log and heartbeat
can emit verbatim.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable


class Counter:
    """Monotonically accumulating value (bytes moved, steps run)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Last-write-wins value (current loss, tokens/s of the last step)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming distribution with a bounded sample window.

    Count/total/min/max are exact over every observation; percentiles
    are computed over the most recent ``window`` samples (enough for
    step-time p50/p99 without unbounded growth — the same reason the
    train loop bounds its loss history).
    """

    __slots__ = ("count", "total", "min", "max", "_window")

    def __init__(self, window: int = 4096) -> None:
        self.count: int = 0
        self.total: float = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._window: deque[float] = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._window.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100] over the retained window (nearest-rank)."""
        if not self._window:
            return 0.0
        xs = sorted(self._window)
        k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[k]

    def summary(self) -> dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named metrics with create-on-first-use semantics.

    Re-requesting a name returns the SAME instrument; requesting an
    existing name as a different type raises (silent shadowing is how
    dashboards end up lying).
    """

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, cls: type, factory: Callable[[], Any]):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(window))

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready view: counters/gauges → number, histograms → summary
        dict.  Keys sorted for deterministic serialization."""
        out: dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

