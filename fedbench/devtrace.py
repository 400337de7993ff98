"""The traced run's readings: the device's activity from ``torch.profiler``
and the program's spans, on one clock.

The profiler records the host's operators and runtime calls and the
card's kernels, copies and sets over the window. Its events carry
epoch nanoseconds; the program's spans carry microseconds since their
tracer's start. A marker taken at the window's opening, one event in
each, ties the two together.

From these: the device's busy time (the union of its activity inside
the window), the time each kernel name took, the idle gaps labelled by
the innermost span the host was in, and, for a list of span names, the
device time of the kernels whose launch fell inside one of those spans.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Optional

MARK = "fedbench.window"
#: runtime calls that launch device work (their correlation id names it)
_LAUNCH_PREFIXES = ("cuda", "cu")


class DeviceTrace:
    """Start with :meth:`open` at the window's opening, :meth:`close` at its
    end; then read."""

    def __init__(self, tracer: Any) -> None:
        self.tracer = tracer
        self._prof: Any = None
        self._mark_tracer_us = 0.0

    def open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.profiler.record_function(MARK):
            self.tracer.instant(MARK)
        self._mark_tracer_us = self._last_instant_ts()

    def _last_instant_ts(self) -> float:
        for ev in reversed(self.tracer.chrome_trace()["traceEvents"]):
            if ev.get("name") == MARK:
                return float(ev["ts"])
        raise RuntimeError("the window marker is missing from the span trace")

    def close(self, window_s: float) -> "TraceReading":
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        return TraceReading(events, self.tracer, self._mark_tracer_us, window_s)


class TraceReading:
    def __init__(self, events: list, tracer: Any, mark_tracer_us: float,
                 window_s: float) -> None:
        mark_ns: Optional[int] = None
        launches: dict[int, int] = {}
        device: list[tuple[int, int, str, int]] = []
        for ev in events:
            dev = str(ev.device_type())
            if dev.endswith("CUDA"):
                device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(),
                               ev.correlation_id()))
                continue
            name = ev.name()
            if name == MARK and mark_ns is None:
                mark_ns = ev.start_ns()
            elif name.startswith(_LAUNCH_PREFIXES):
                launches[ev.correlation_id()] = ev.start_ns()
        if mark_ns is None:
            raise RuntimeError("the window marker is missing from the profile")
        self.t0 = mark_ns
        self.t1 = mark_ns + int(window_s * 1e9)
        self.window_s = window_s
        self.device = sorted((a, b, n, c) for a, b, n, c in device if b > self.t0 and a < self.t1)
        self.launches = launches
        # the program's spans on the profile's clock
        self.spans = []
        trace = tracer.chrome_trace()
        if trace["otherData"]["dropped_events"]:
            raise RuntimeError("the span tracer dropped events; raise its capacity")
        for ev in trace["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            a = mark_ns + int((float(ev["ts"]) - mark_tracer_us) * 1e3)
            b = a + int(float(ev["dur"]) * 1e3)
            if b > self.t0 and a < self.t1:
                self.spans.append({**ev, "a": a, "b": b})

    # -- the device ---------------------------------------------------------
    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for a, b, _, _ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_ops(self, top: int = 10) -> list[list[Any]]:
        by_name: dict[str, int] = defaultdict(int)
        for a, b, name, _ in self.device:
            by_name[name] += min(b, self.t1) - max(a, self.t0)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def _timeline(self) -> tuple[list[int], list[str]]:
        """Cut points and, between each pair, the innermost span the host
        was in (``"no span"`` outside every span)."""
        cuts = sorted({self.t0, self.t1} | {t for sp in self.spans for t in (sp["a"], sp["b"])})
        labels = []
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) // 2
            inner = min((sp for sp in self.spans if sp["a"] <= mid <= sp["b"]),
                        key=lambda sp: sp["b"] - sp["a"], default=None)
            if inner is None:
                labels.append("no span")
            else:
                kind = inner.get("args", {}).get("kind")
                labels.append(f"{inner['name']}:{kind}" if kind else inner["name"])
        return cuts, labels

    def idle_gaps(self, top: int = 10) -> list[list[Any]]:
        """The device's idle time split by the innermost span the host was
        in meanwhile, the largest totals first."""
        cuts, labels = self._timeline()
        by_label: dict[str, int] = defaultdict(int)
        prev = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > prev:   # an idle gap [prev, a): split it at the cuts
                i = max(0, bisect.bisect_right(cuts, prev) - 1)
                lo = prev
                while lo < a and i < len(labels):
                    hi = min(a, cuts[i + 1])
                    if hi > lo:
                        by_label[labels[i]] += hi - lo
                    lo = max(lo, hi)
                    i += 1
            prev = max(prev, b)
        ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    # -- spans ---------------------------------------------------------------
    def span_rounds(self) -> dict[str, list[float]]:
        """The seconds of each transmit (by kind) and each client's local
        steps, in order: how the rounds of the window compare."""
        out: dict[str, list[float]] = {}
        for sp in self.spans:
            if sp["name"] in ("wire.transmit", "client.train"):
                key = f"{sp['name']}:{sp.get('args', {}).get('kind', '')}".rstrip(":")
                out.setdefault(key, []).append(round(sp["dur"] / 1e6, 3))
        return out

    def span_seconds(self, name: str, **args: Any) -> float:
        return sum(sp["dur"] for sp in self.spans if sp["name"] == name and all(
            sp.get("args", {}).get(k) == v for k, v in args.items())) / 1e6

    def device_s_launched_in(self, names: tuple[str, ...],
                             skip_prefixes: tuple[str, ...] = ()) -> Optional[float]:
        """Device seconds of the work launched inside any span named in
        ``names`` (names starting with ``skip_prefixes`` left out); None
        when no such span ran in the window."""
        merged: list[list[int]] = []
        for a, b in sorted((sp["a"], sp["b"]) for sp in self.spans if sp["name"] in names):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        if not merged:
            return None
        starts = [a for a, _ in merged]
        total = 0
        for a, b, name, corr in self.device:
            t = self.launches.get(corr)
            if t is None or name.startswith(skip_prefixes):
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                total += b - a
        return total / 1e9
