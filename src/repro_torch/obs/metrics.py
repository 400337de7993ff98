"""Labeled metrics registry with JSON-safe snapshots.

A :class:`MetricsRegistry` holds named series of three instrument
kinds — :class:`Counter` (monotone), :class:`Gauge` (last value wins)
and :class:`Histogram` (count/sum/min/max + log2 buckets) — each keyed
by name plus a small label set, Prometheus-style::

    reg = MetricsRegistry()
    reg.counter("wire.items", direction="up").inc()
    reg.gauge("sched.queue_depth").set(7)
    reg.histogram("wire.item_bytes").observe(36864)
    json.dumps(reg.snapshot())      # always JSON-safe

``snapshot()`` is the single export surface: the simulator publishes
``TrafficStats`` / ``MemoryMeter`` / ``RuntimeStats`` ``as_dict()``
exports into its per-run registry (:meth:`MetricsRegistry.publish`), and
``run_job`` / ``benchmarks/run.py --json`` embed the snapshot, so every
counter that used to live on an island travels in one schema.

Instruments are thread-safe (one lock per instrument; the registry lock
only guards series creation), matching the async runtime's concurrent
worker threads.

Activation mirrors :mod:`repro_torch.obs.trace` and
:class:`repro_torch.utils.mem.MemoryMeter`: a module-level :data:`ACTIVE`
slot set by the :func:`activate` context manager. Hot paths (the wire
encode-ahead loop) read ``metrics.ACTIVE`` once and branch on None, so
an inactive registry costs one global load per item.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections.abc import Iterator, Mapping
from typing import Any, Optional, Union

Number = Union[int, float]

#: the active registry; hot paths read this directly and branch on None
ACTIVE: Optional["MetricsRegistry"] = None


def active() -> Optional["MetricsRegistry"]:
    return ACTIVE


@contextlib.contextmanager
def activate(registry: "MetricsRegistry") -> Iterator["MetricsRegistry"]:
    """Install ``registry`` as the process-wide active registry, so
    instrumented hot paths (wire encode-ahead stalls, queue depths)
    record into the run that is currently executing."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = registry
    try:
        yield registry
    finally:
        ACTIVE = prev


def _series_key(name: str, labels: Mapping[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value: Number = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self.value += n

    def as_value(self) -> Number:
        return self.value


class Gauge:
    """Last-written value."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value: Number = 0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self.value = v

    def max(self, v: Number) -> None:
        """High-watermark update (keeps the larger of old and new)."""
        with self._lock:
            if v > self.value:
                self.value = v

    def as_value(self) -> Number:
        return self.value


class Histogram:
    """Streaming distribution summary: count / sum / min / max plus
    power-of-two buckets (bucket ``k`` counts observations in
    ``[2^(k-1), 2^k)``; zero and negatives land in bucket 0)."""

    __slots__ = ("count", "total", "min", "max", "buckets", "_lock")

    def __init__(self) -> None:
        self.count = 0
        self.total: float = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: dict[int, int] = {}
        self._lock = threading.Lock()

    def observe(self, v: Number) -> None:
        v = float(v)
        b = max(0, int(math.floor(math.log2(v))) + 1) if v > 0 else 0
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.buckets[b] = self.buckets.get(b, 0) + 1

    def as_value(self) -> dict[str, Any]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.total,
                "min": self.min,
                "max": self.max,
                "mean": (self.total / self.count) if self.count else None,
                "buckets": {str(k): v for k, v in sorted(self.buckets.items())},
            }


class MetricsRegistry:
    """Get-or-create registry of labeled metric series.

    The same ``(kind, name, labels)`` triple always returns the same
    instrument; asking for an existing name with a different kind is an
    error (one series, one meaning).
    """

    def __init__(self) -> None:
        self._series: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls: type, name: str, labels: Mapping[str, Any]) -> Any:
        key = _series_key(name, labels)
        inst = self._series.get(key)
        if inst is None:
            with self._lock:
                inst = self._series.setdefault(key, cls())
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {key!r} already registered as {type(inst).__name__}, "
                f"requested as {cls.__name__}"
            )
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    def publish(self, prefix: str, values: Mapping[str, Any],
                **labels: Any) -> None:
        """Export a flat stats dict (e.g. ``TrafficStats.as_dict()``)
        as gauges named ``prefix.key``; non-numeric values are skipped."""
        for k, v in values.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.gauge(f"{prefix}.{k}", **labels).set(v)

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe view of every series, grouped by instrument kind."""
        out: dict[str, dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {},
        }
        with self._lock:
            series = dict(self._series)
        for key, inst in sorted(series.items()):
            group = {Counter: "counters", Gauge: "gauges",
                     Histogram: "histograms"}[type(inst)]
            out[group][key] = inst.as_value()
        return out
