"""Byte-exact peak-memory accounting for the streaming benchmarks.

The paper's Table III reports host peak-RSS under three transmission
settings. RSS is machine/allocator dependent, so the framework instruments
the *transmission buffers themselves*: every buffer the message layer
allocates registers its size with the active :class:`MemoryMeter`, which
tracks live bytes and the high-water mark. This reproduces the paper's
mechanism (regular = whole blob live, container = one item live, file =
one chunk live) deterministically.

An optional RSS probe (``/proc/self/status`` VmHWM) is included for the
benchmark's "measured" column when running the real simulation.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from collections.abc import Iterator
from typing import Optional


class MemoryMeter:
    """Tracks live transmission-buffer bytes and the peak.

    Besides the live/peak pair, two cumulative counters feed the
    zero-copy wire benchmarks: ``total_allocated`` sums every buffer the
    wire layer registered (how many times data got a new home), and
    ``copied`` sums the bytes the layer physically memcpy'd (joins,
    ``tobytes()`` exports, reassembly fills). A scatter-gather transfer
    moves the same wire bytes with a fraction of both.

    Thread-safe: the async runtime's worker threads stream concurrently,
    so ``alloc``/``free``/``hold`` all serialize on a per-instance lock
    (per-instance so independent meters don't contend).
    """

    _active: Optional[MemoryMeter] = None

    def __init__(self) -> None:
        self.live = 0
        self.peak = 0
        self.total_allocated = 0
        self.copied = 0
        self._lock = threading.Lock()

    # -- accounting -------------------------------------------------------
    def alloc(self, nbytes: int) -> None:
        with self._lock:
            self.live += int(nbytes)
            self.total_allocated += int(nbytes)
            if self.live > self.peak:
                self.peak = self.live

    def free(self, nbytes: int) -> None:
        with self._lock:
            self.live = max(0, self.live - int(nbytes))

    def copy(self, nbytes: int) -> None:
        with self._lock:
            self.copied += int(nbytes)

    @contextmanager
    def hold(self, nbytes: int) -> Iterator[None]:
        self.alloc(nbytes)
        try:
            yield
        finally:
            self.free(nbytes)

    def as_dict(self) -> dict:
        """JSON-safe export (the metrics-snapshot schema)."""
        with self._lock:
            return {
                "live": self.live,
                "peak": self.peak,
                "total_allocated": self.total_allocated,
                "copied": self.copied,
            }

    # -- active-meter plumbing --------------------------------------------
    @classmethod
    def current(cls) -> Optional[MemoryMeter]:
        return cls._active

    @contextmanager
    def activate(self) -> Iterator[MemoryMeter]:
        prev = MemoryMeter._active
        MemoryMeter._active = self
        try:
            yield self
        finally:
            MemoryMeter._active = prev


def record_alloc(nbytes: int) -> None:
    meter = MemoryMeter.current()
    if meter is not None:
        meter.alloc(nbytes)


def record_free(nbytes: int) -> None:
    meter = MemoryMeter.current()
    if meter is not None:
        meter.free(nbytes)


def record_copy(nbytes: int) -> None:
    """One physical byte-copy performed by the wire layer (join,
    ``tobytes`` export, receive-buffer fill)."""
    meter = MemoryMeter.current()
    if meter is not None:
        meter.copy(nbytes)


@contextmanager
def record_hold(nbytes: int) -> Iterator[None]:
    meter = MemoryMeter.current()
    if meter is None:
        yield
    else:
        with meter.hold(nbytes):
            yield


def rss_peak_kb() -> Optional[int]:
    """VmHWM from /proc, if available (Linux)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None
