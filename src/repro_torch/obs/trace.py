"""Thread-safe span tracer with dual clocks and Chrome trace export.

One :class:`Tracer` records two kinds of timestamps into a single
bounded ring buffer (the flight recorder):

* **wall-clock spans/instants/counters** — ``perf_counter``-based, one
  Perfetto track per real thread (``pid`` :data:`PID_WALL`). These show
  where host time goes: pipeline stage encode/decode, kernel dispatch,
  socket writes.
* **simulated-clock spans/instants/counters** — explicit timestamps in
  simulated seconds from the event scheduler (``pid`` :data:`PID_SIM`),
  one track per client. These show the federation's *timeline*:
  downlink / compute / uplink segments per round trip, dropouts,
  queue depth.

Exported traces are Chrome trace-event JSON (the ``traceEvents`` array
format): load the file in https://ui.perfetto.dev or ``chrome://tracing``
and the two clocks appear as two processes, "wall clock" and
"simulated time". :func:`validate_chrome_trace` is the schema check the
test suite and CI run over every exported trace.

Activation mirrors :class:`repro_torch.utils.mem.MemoryMeter`: a module-level
:data:`ACTIVE` slot, set by the :func:`activate` context manager. Hot
paths read ``trace.ACTIVE`` directly and branch once — when it is None
(the default) tracing costs one global load and an ``is None`` test,
with no allocation and no call. The :func:`span` helper exists for cool
paths only (round loops, settle waves), where a shared no-op context
manager is cheap enough.

The tracer is write-only during a run (append to a ``deque``, which is
atomic under the GIL; the thread-id map takes a lock on first sight of
a new thread), so worker threads trace concurrently without contention.
Nothing here reads the wall clock into *simulated* event times — tracing
cannot perturb a deterministic timeline.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from collections.abc import Callable, Iterator
from typing import Any, Optional

#: Perfetto "process" ids for the two clocks
PID_WALL = 1
PID_SIM = 2

#: the active tracer; hot paths read this directly and branch on None
ACTIVE: Optional["Tracer"] = None


def active() -> Optional["Tracer"]:
    return ACTIVE


@contextlib.contextmanager
def activate(tracer: "Tracer") -> Iterator["Tracer"]:
    """Install ``tracer`` as the process-wide active tracer."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = tracer
    try:
        yield tracer
    finally:
        ACTIVE = prev


_NOOP = contextlib.nullcontext()


def span(name: str, cat: str = "", **args: Any) -> Any:
    """Cool-path helper: a span when tracing is on, a shared no-op
    context manager otherwise. Hot loops should read :data:`ACTIVE`
    once and branch instead (no call, no allocation when off)."""
    tr = ACTIVE
    return _NOOP if tr is None else tr.span(name, cat, **args)


class _Span:
    """One in-flight wall-clock span (context manager).

    ``args`` stays attached to the emitted event by reference, so a
    caller may still fill in late-known fields (byte counts) inside the
    ``with`` block after the traced call returned.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_sim_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        if self._tracer.sync is not None:
            self._tracer.sync()
        sim = self._tracer.sim_clock
        self._sim_t0 = sim() if sim is not None else None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        tr = self._tracer
        if tr.sync is not None:
            tr.sync()
        t1 = time.perf_counter_ns()
        if self._sim_t0 is not None:
            self.args["sim_t"] = round(self._sim_t0, 9)
        tr._emit({
            "ph": "X",
            "name": self.name,
            "cat": self.cat or "span",
            "pid": PID_WALL,
            "tid": tr._wall_tid(),
            "ts": (self._t0 - tr._epoch_ns) / 1000.0,
            "dur": (t1 - self._t0) / 1000.0,
            "args": self.args,
        })


class Tracer:
    """Bounded flight recorder emitting Chrome trace events.

    ``capacity`` bounds the ring buffer: the newest events win, and the
    export reports how many older events were dropped. ``sim_clock``
    (bound by the simulator when the async scheduler runs) lets every
    wall-clock span also carry the simulated time at which it ran.

    ``sync`` (e.g. ``torch.cuda.synchronize``) runs when every span opens
    and closes, so a span's wall time includes the device work launched
    inside it rather than only the host time to enqueue it. It
    serializes host and device at each span edge, which is the cost of
    turning it on.
    """

    def __init__(self, capacity: int = 1 << 16,
                 sim_clock: Optional[Callable[[], float]] = None,
                 sync: Optional[Callable[[], None]] = None) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.sim_clock = sim_clock
        self.sync = sync
        self._events: deque = deque(maxlen=capacity)
        self._epoch_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._tids: dict[tuple[int, str], int] = {}
        self._total = 0

    # -- bookkeeping --------------------------------------------------------
    def _emit(self, event: dict[str, Any]) -> None:
        self._total += 1          # benign race: a statistic, not an index
        self._events.append(event)

    def _tid(self, pid: int, label: str) -> int:
        key = (pid, label)
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(key, len(self._tids) + 1)
        return tid

    def _wall_tid(self) -> int:
        return self._tid(PID_WALL, threading.current_thread().name)

    @property
    def total_events(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        return self._total - len(self._events)

    def _wall_ts(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1000.0

    # -- wall-clock events --------------------------------------------------
    def span(self, name: str, cat: str = "", **args: Any) -> _Span:
        """A nested wall-clock span (context manager). Spans opened on
        one thread nest by containment on that thread's track."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        self._emit({
            "ph": "i", "name": name, "cat": cat or "instant",
            "pid": PID_WALL, "tid": self._wall_tid(),
            "ts": self._wall_ts(), "s": "t", "args": args,
        })

    def counter(self, name: str, value: float, cat: str = "") -> None:
        self._emit({
            "ph": "C", "name": name, "cat": cat or "counter",
            "pid": PID_WALL, "tid": 0,
            "ts": self._wall_ts(), "args": {"value": float(value)},
        })

    # -- simulated-clock events ---------------------------------------------
    def sim_span(self, name: str, t0_s: float, t1_s: float, track: str,
                 cat: str = "sim", **args: Any) -> None:
        """A span on the simulated timeline: ``[t0_s, t1_s]`` in
        simulated seconds on the named track (one track per client)."""
        self._emit({
            "ph": "X", "name": name, "cat": cat,
            "pid": PID_SIM, "tid": self._tid(PID_SIM, track),
            "ts": t0_s * 1e6, "dur": max(0.0, (t1_s - t0_s)) * 1e6,
            "args": args,
        })

    def sim_instant(self, name: str, t_s: float, track: str,
                    cat: str = "sim", **args: Any) -> None:
        self._emit({
            "ph": "i", "name": name, "cat": cat,
            "pid": PID_SIM, "tid": self._tid(PID_SIM, track),
            "ts": t_s * 1e6, "s": "t", "args": args,
        })

    def sim_counter(self, name: str, t_s: float, value: float) -> None:
        self._emit({
            "ph": "C", "name": name, "cat": "sim",
            "pid": PID_SIM, "tid": 0,
            "ts": t_s * 1e6, "args": {"value": float(value)},
        })

    # -- export -------------------------------------------------------------
    def chrome_trace(self) -> dict[str, Any]:
        """The flight recorder as a Chrome trace-event JSON object."""
        meta: list[dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": PID_WALL, "tid": 0,
             "args": {"name": "wall clock"}},
            {"ph": "M", "name": "process_name", "pid": PID_SIM, "tid": 0,
             "args": {"name": "simulated time"}},
        ]
        with self._lock:
            tids = dict(self._tids)
        for (pid, label), tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": label}})
        return {
            "traceEvents": meta + list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {
                "total_events": self._total,
                "dropped_events": self.dropped,
                "capacity": self.capacity,
            },
        }

    def write(self, path: str) -> dict[str, Any]:
        """Serialize the trace to ``path``; returns a small summary."""
        obj = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return {"path": path, "events": len(obj["traceEvents"]),
                "dropped": self.dropped}


# ---------------------------------------------------------------------------
# Schema validation (tests + CI run this over every exported trace)
# ---------------------------------------------------------------------------

_KNOWN_PH = {"X", "B", "E", "i", "I", "C", "M"}
_TS_REQUIRED = {"X", "B", "E", "i", "I", "C"}


def _fail(i: int, ev: Any, why: str) -> None:
    raise ValueError(f"trace event {i} is not valid Chrome trace JSON: "
                     f"{why} (event: {ev!r})")


def validate_chrome_trace(obj: Any) -> int:
    """Assert ``obj`` is a valid Chrome trace-event JSON object (the
    ``traceEvents``-array form Perfetto ingests). Raises ``ValueError``
    on the first violation; returns the number of events checked."""
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError('a Chrome trace is an object with a "traceEvents" list')
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"trace is not JSON-serializable: {exc}") from exc
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            _fail(i, ev, "event is not an object")
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            _fail(i, ev, f"unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            _fail(i, ev, "missing string name")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            _fail(i, ev, "pid/tid must be integers")
        if ph in _TS_REQUIRED:
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                _fail(i, ev, f"bad timestamp {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                _fail(i, ev, f"complete event needs a non-negative dur, got {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                _fail(i, ev, "counter event needs numeric args")
        if ph == "M" and ev["name"] in ("process_name", "thread_name"):
            args = ev.get("args")
            if not isinstance(args, dict) or not isinstance(args.get("name"), str):
                _fail(i, ev, "metadata event needs args.name")
        if "args" in ev and not isinstance(ev["args"], dict):
            _fail(i, ev, "args must be an object")
    return len(obj["traceEvents"])
