"""Deterministic simulated-clock event loop for the async FL runtime.

Mirror of ``src/repro/runtime/events.py`` (pure Python, copied as is).

The scheduler never reads the wall clock: every latency in the system —
link transmission time derived from *actual* wire bytes, client compute
time, dropout instants — is expressed in **simulated seconds** and pushed
onto one priority queue. Two runs with the same seeds pop the exact same
event sequence, which is what makes the async federation reproducible
and lets tests assert bitwise equality against the synchronous
controller.

Ordering is (time, seq): ``seq`` is a monotonically increasing insertion
counter, so simultaneous events resolve in schedule order rather than by
heap internals. The loop itself is randomness-free; jitter draws live in
the network model's per-client RNG streams and dropout draws in the
scheduler's seeded stream. Nothing here touches ``time.time()``.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
import heapq
import json
import math
from random import Random
from collections.abc import Iterator, Mapping, Sequence
from typing import Any, Optional


class EventKind(enum.Enum):
    DISPATCH = "dispatch"        # server hands a task to a client link
    ARRIVAL = "arrival"          # task data fully received by the client
    COMPLETION = "completion"    # task result fully received by the server
    DROPOUT = "dropout"          # client failed mid-round (injected fault)
    RETRY = "retry"              # re-dispatch after a dropout
    MODEL_UPDATE = "model_update"  # aggregation produced a new global version
    DEFERRED = "deferred"        # dispatch parked until the client's next arrival
    INTERRUPT = "interrupt"      # client departed mid round trip (availability)


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int
    kind: EventKind
    client: Optional[str] = None
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def sort_key(self):
        return (self.time, self.seq)


class EventLoop:
    """Min-heap of :class:`Event` with a monotone simulated clock."""

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list[tuple] = []
        self._seq = 0
        self.history: list[Event] = []

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def empty(self) -> bool:
        return not self._heap

    def schedule(
        self,
        delay: float,
        kind: EventKind,
        client: Optional[str] = None,
        **data: Any,
    ) -> Event:
        """Schedule ``kind`` at ``now + delay`` (delay in simulated seconds)."""
        return self.schedule_at(self.now + max(0.0, float(delay)), kind, client, **data)

    def schedule_at(
        self,
        time: float,
        kind: EventKind,
        client: Optional[str] = None,
        **data: Any,
    ) -> Event:
        if time < self.now:
            raise ValueError(f"cannot schedule into the past ({time} < {self.now})")
        ev = Event(float(time), self._seq, kind, client, data)
        self._seq += 1
        heapq.heappush(self._heap, (ev.sort_key(), ev))
        return ev

    def peek(self) -> Event:
        """The earliest queued event, without popping or advancing time."""
        if not self._heap:
            raise IndexError("peek into empty event loop")
        return self._heap[0][1]

    def pop(self) -> Event:
        """Pop the earliest event and advance the clock to it."""
        if not self._heap:
            raise IndexError("pop from empty event loop")
        _, ev = heapq.heappop(self._heap)
        self.now = ev.time
        self.history.append(ev)
        return ev

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()


# ---------------------------------------------------------------------------
# Client availability: arrival/departure schedules
# ---------------------------------------------------------------------------

class AvailabilityTrace:
    """Per-client online windows (arrival/departure schedule).

    ``intervals`` maps a client name to half-open ``[start, end)`` windows
    in simulated seconds during which the client is reachable; ``end`` may
    be ``inf`` for an open-ended final window. Clients absent from the
    mapping are **always online** — an empty trace is the idealized fleet.

    This replaces Bernoulli-only dropout with the trace-driven churn of
    real cross-device fleets: the scheduler defers dispatches to offline
    clients until their next arrival, and a departure mid round trip
    interrupts the trip (the task is re-dispatched on return). Traces are
    plain data — load them from a file (:meth:`from_file`) or synthesize
    them (:func:`periodic_availability`, :func:`random_availability`).
    """

    def __init__(self, intervals: Mapping[str, Sequence[tuple[float, float]]]) -> None:
        self._starts: dict[str, list[float]] = {}
        self._ends: dict[str, list[float]] = {}
        for client, wins in intervals.items():
            merged = _merge_windows(wins)
            self._starts[client] = [s for s, _ in merged]
            self._ends[client] = [e for _, e in merged]

    # -- queries -----------------------------------------------------------
    def _window_index(self, client: str, t: float) -> int:
        """Index of the last window starting at or before ``t`` (-1: none)."""
        return bisect.bisect_right(self._starts[client], t) - 1

    def is_online(self, client: str, t: float) -> bool:
        if client not in self._starts:
            return True
        i = self._window_index(client, t)
        return i >= 0 and t < self._ends[client][i]

    def next_arrival(self, client: str, t: float) -> float:
        """Earliest time >= ``t`` at which ``client`` is online (``t`` itself
        if already online; ``inf`` if the client never returns)."""
        if self.is_online(client, t):
            return t
        starts = self._starts[client]
        i = bisect.bisect_left(starts, t)
        return starts[i] if i < len(starts) else math.inf

    def online_until(self, client: str, t: float) -> float:
        """End of the online window containing ``t`` (``t`` if offline,
        ``inf`` if the client is always online / in an open-ended window)."""
        if client not in self._starts:
            return math.inf
        i = self._window_index(client, t)
        if i < 0 or t >= self._ends[client][i]:
            return t
        return self._ends[client][i]

    def clients(self) -> list[str]:
        return list(self._starts)

    def windows(self, client: str) -> list[tuple[float, float]]:
        if client not in self._starts:
            return [(0.0, math.inf)]
        return list(zip(self._starts[client], self._ends[client]))

    # -- (de)serialization -------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> AvailabilityTrace:
        """Load a trace: JSON ``{"client": [[start, end], ...]}`` or CSV
        lines ``client,start,end`` (``end`` may be ``inf``); ``#`` comments
        and blank lines are skipped in CSV."""
        with open(path) as fh:
            text = fh.read()
        if text.lstrip().startswith("{"):
            raw = json.loads(text)
            return cls({c: [(float(s), float(e)) for s, e in wins] for c, wins in raw.items()})
        intervals: dict[str, list[tuple[float, float]]] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            client, start, end = (f.strip() for f in line.split(","))
            intervals.setdefault(client, []).append((float(start), float(end)))
        return cls(intervals)

    def to_file(self, path: str) -> None:
        payload = {
            c: [[s, "inf" if math.isinf(e) else e] for s, e in self.windows(c)]
            for c in self._starts
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1)


def _merge_windows(wins: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sort, validate, and merge overlapping/adjacent online windows."""
    out: list[tuple[float, float]] = []
    for start, end in sorted((float(s), float(e)) for s, e in wins):
        if end <= start:
            raise ValueError(f"empty availability window [{start}, {end})")
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def periodic_availability(
    clients: Sequence[str],
    period_s: float,
    horizon_s: float,
    duty_cycle: float = 0.5,
    stagger: bool = True,
) -> AvailabilityTrace:
    """Diurnal-style availability: each client is online for the first
    ``duty_cycle`` fraction of every ``period_s`` window, phase-shifted
    per client when ``stagger`` so the fleet never goes dark at once.
    After ``horizon_s`` every client comes (and stays) online, so jobs
    always terminate."""
    if not 0.0 < duty_cycle <= 1.0:
        raise ValueError("duty_cycle must be in (0, 1]")
    if not math.isfinite(horizon_s) or horizon_s <= 0:
        raise ValueError("horizon_s must be finite and positive")
    intervals: dict[str, list[tuple[float, float]]] = {}
    for i, client in enumerate(clients):
        offset = (i / max(1, len(clients))) * period_s if stagger else 0.0
        wins: list[tuple[float, float]] = []
        # the tail of the previous (phase-shifted) on-window may cover t=0
        head_end = offset - (1.0 - duty_cycle) * period_s
        if offset > 0.0 and head_end > 0.0:
            wins.append((0.0, min(head_end, horizon_s)))
        start = offset
        while start < horizon_s:
            wins.append((start, min(start + duty_cycle * period_s, horizon_s)))
            start += period_s
        wins.append((horizon_s, math.inf))
        intervals[client] = wins
    return AvailabilityTrace(intervals)


def availability_from_spec(spec: Mapping, clients: Sequence[str]) -> AvailabilityTrace:
    """Build an AvailabilityTrace from a declarative job-spec dict.

    Shapes (``kind`` selects the source)::

        {"kind": "file", "path": "traces/fleet.json"}
        {"kind": "windows", "windows": {"site-0": [[0, 10], [20, "inf"]]}}
        {"kind": "periodic", "period_s": 60, "duty_cycle": 0.5,
         "horizon_s": 600, "stagger": true}
        {"kind": "random", "mean_online_s": 120, "mean_offline_s": 60,
         "horizon_s": 600, "seed": 0}
    """
    spec = dict(spec)
    kind = spec.get("kind", "windows" if "windows" in spec else None)
    if kind == "file":
        return AvailabilityTrace.from_file(spec["path"])
    if kind == "windows":
        return AvailabilityTrace(
            {c: [(float(s), float(e)) for s, e in wins]
             for c, wins in spec["windows"].items()}
        )
    if kind == "periodic":
        return periodic_availability(
            clients,
            period_s=float(spec["period_s"]),
            horizon_s=float(spec["horizon_s"]),
            duty_cycle=float(spec.get("duty_cycle", 0.5)),
            stagger=bool(spec.get("stagger", True)),
        )
    if kind == "random":
        return random_availability(
            clients,
            mean_online_s=float(spec["mean_online_s"]),
            mean_offline_s=float(spec["mean_offline_s"]),
            horizon_s=float(spec["horizon_s"]),
            seed=int(spec.get("seed", 0)),
        )
    raise ValueError(f"unknown availability spec kind: {kind!r}")


def random_availability(
    clients: Sequence[str],
    mean_online_s: float,
    mean_offline_s: float,
    horizon_s: float,
    seed: int = 0,
) -> AvailabilityTrace:
    """Churn model: each client alternates exponentially-distributed
    online/offline stretches (its own seeded stream, so traces are
    deterministic and independent across clients). After ``horizon_s``
    everyone stays online so the federation can always finish."""
    if mean_online_s <= 0 or mean_offline_s <= 0:
        raise ValueError("mean_online_s and mean_offline_s must be positive "
                         "(for an always-online fleet, omit the trace)")
    if not math.isfinite(horizon_s) or horizon_s <= 0:
        raise ValueError("horizon_s must be finite and positive")
    intervals: dict[str, list[tuple[float, float]]] = {}
    for client in clients:
        rng = Random(f"avail:{seed}:{client}")
        wins: list[tuple[float, float]] = []
        duty = mean_online_s / (mean_online_s + mean_offline_s)
        t = 0.0 if rng.random() < duty else rng.expovariate(1.0 / mean_offline_s)
        while t < horizon_s:
            end = t + rng.expovariate(1.0 / mean_online_s)
            wins.append((t, min(end, horizon_s)))
            t = end + rng.expovariate(1.0 / mean_offline_s)
        wins.append((horizon_s, math.inf))
        intervals[client] = wins
    return AvailabilityTrace(intervals)
