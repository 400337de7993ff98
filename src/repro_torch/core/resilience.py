"""Operational resilience for the streaming layer (paper §I: "potential
job disruptions due to network interruptions"; §V: "evaluation of
operational resilience for the streaming mechanism").

Components:

* :class:`LossyDriver` — fault-injection wrapper for any driver: seeded
  random chunk drop / duplication / reordering (the WAN misbehaviours an
  FL deployment sees).
* :class:`OrderedDeliveryBuffer` — receiver-side sequencer: deduplicates
  and releases chunks to the real receiver strictly in ``seq`` order, and
  reports the missing-seq set.
* :class:`ReliableTransfer` — sender-side repair loop: records framed
  chunks, transmits through the (possibly lossy) driver, then
  retransmits whatever the receiver reports missing until the stream
  completes (NVFlare's resend-on-gap, pull-based) or retries exhaust.
* :class:`ChaosProxy` — the live-plane sibling of :class:`LossyDriver`:
  a TCP forwarder that injects deterministic byte-offset-triggered
  faults (stall / blackhole / corrupt / throttle) between one real
  client and the federation server, so the fault-tolerance layer is
  tested against real sockets, not simulated drivers.

Works with every streamer/receiver pair unchanged — resilience is a
transport concern, invisible to the container/file layers above
(the SFM layering claim of the paper). The simulator wire composes these
end-to-end: set ``chunk_drop_prob``/``chunk_dup_prob``/
``chunk_reorder_window`` on :class:`~repro_torch.fl.simulator.SimulationConfig`
and every hop runs through LossyDriver + ReliableTransfer, with
retransmitted chunks counted into the true wire bytes that drive the
async runtime's simulated transfer time.

Mirror of ``src/repro/core/resilience.py``: the faults are drawn from
``random.Random`` seeded with the same key (the simulator's string
key), so one key gives the same drop / duplicate / reorder pattern in
both packages.
"""
from __future__ import annotations

import contextlib
import random
import socket
import threading
import time
from collections.abc import Callable, Mapping
from typing import Any, Optional

from repro_torch.core import streaming as sm


class LossyDriver(sm.Driver):
    """Randomly drops, duplicates and reorders chunks (seeded)."""

    def __init__(
        self,
        inner: sm.Driver,
        *,
        drop_prob: float = 0.0,
        dup_prob: float = 0.0,
        reorder_window: int = 0,
        seed: int = 0,
    ) -> None:
        self.inner = inner
        self.drop_prob = drop_prob
        self.dup_prob = dup_prob
        self.reorder_window = reorder_window
        self._rng = random.Random(seed)
        self._pending: list[sm.Chunk] = []

    def connect(self, on_chunk: Callable[[sm.Chunk], None]) -> None:
        self.inner.connect(on_chunk)

    def _emit(self, chunk: sm.Chunk) -> None:
        if self._rng.random() < self.drop_prob:
            return
        self.inner.send(chunk)
        if self._rng.random() < self.dup_prob:
            self.inner.send(chunk)

    def send(self, chunk: sm.Chunk) -> None:
        if self.reorder_window > 0:
            self._pending.append(chunk)
            if len(self._pending) >= self.reorder_window:
                self._rng.shuffle(self._pending)
                for c in self._pending:
                    self._emit(c)
                self._pending.clear()
        else:
            self._emit(chunk)

    def flush(self) -> None:
        for c in self._pending:
            self._emit(c)
        self._pending.clear()
        if hasattr(self.inner, "flush"):
            self.inner.flush()

    def close(self) -> None:
        self.flush()
        self.inner.close()


class OrderedDeliveryBuffer:
    """Dedup + in-order release to the wrapped receiver callback."""

    def __init__(self, on_chunk: Callable[[sm.Chunk], None]) -> None:
        self._on_chunk = on_chunk
        self._buffer: dict[int, sm.Chunk] = {}
        self._next_seq = 0
        self._eof_seq: Optional[int] = None
        self.complete = False

    def on_chunk(self, chunk: sm.Chunk) -> None:
        if chunk.seq < self._next_seq or chunk.seq in self._buffer:
            return  # duplicate
        self._buffer[chunk.seq] = chunk
        if chunk.eof:
            self._eof_seq = chunk.seq
        while self._next_seq in self._buffer:
            c = self._buffer.pop(self._next_seq)
            self._on_chunk(c)
            self._next_seq += 1
        if self._eof_seq is not None and self._next_seq > self._eof_seq:
            self.complete = True

    def missing(self) -> set[int]:
        """Known gaps below the highest seq seen (or below eof)."""
        high = self._eof_seq if self._eof_seq is not None else (
            max(self._buffer) if self._buffer else self._next_seq - 1
        )
        return {
            s for s in range(self._next_seq, high + 1) if s not in self._buffer
        }


class ReliableTransfer:
    """Record-and-repair send of one container/blob/file stream."""

    def __init__(self, driver: sm.Driver, chunk_size: int = sm.DEFAULT_CHUNK_SIZE) -> None:
        self.driver = driver
        self.chunk_size = chunk_size
        self.retransmits = 0

    def _send(self, stream_fn: Callable[[sm.Driver], None], receiver, max_rounds: int) -> bool:
        """Stream through a recording wrapper, then repair gaps the
        receiver-side :class:`OrderedDeliveryBuffer` reports until the
        stream completes or ``max_rounds`` retransmission rounds pass.
        Returns True when the receiver's stream completed."""
        sent: dict[int, sm.Chunk] = {}
        buffer = OrderedDeliveryBuffer(receiver.on_chunk)

        class _Recording(sm.Driver):
            def __init__(self, inner: sm.Driver) -> None:
                self.inner = inner

            def connect(self, cb):  # pragma: no cover - wired below
                self.inner.connect(cb)

            def send(self, chunk: sm.Chunk) -> None:
                sent[chunk.seq] = chunk
                self.inner.send(chunk)

        self.driver.connect(buffer.on_chunk)
        stream_fn(_Recording(self.driver))
        if hasattr(self.driver, "flush"):
            self.driver.flush()

        rounds = 0
        while not buffer.complete and rounds < max_rounds:
            gaps = buffer.missing()
            if not gaps and buffer._eof_seq is None:
                # eof itself was lost: resend the tail
                gaps = {max(sent)}
            for seq in sorted(gaps):
                self.driver.send(sent[seq])
                self.retransmits += 1
            if hasattr(self.driver, "flush"):
                self.driver.flush()
            rounds += 1
        return buffer.complete

    def send_container(
        self,
        sd,
        receiver,
        *,
        mode: str = "container",
        max_rounds: int = 20,
    ) -> bool:
        """Returns True when the receiver's stream completed."""
        if mode == "container":
            fn = lambda d: sm.ContainerStreamer(d, self.chunk_size).send_container(sd)
        else:
            fn = lambda d: sm.ObjectStreamer(d, self.chunk_size).send_container(sd)
        return self._send(fn, receiver, max_rounds)

    def send_items(self, items, total: int, receiver, *, max_rounds: int = 20) -> bool:
        """Container-mode send of pre-encoded (name, bytes) items — the
        wire-pipeline path: stage transforms ran upstream, per item."""
        return self._send(
            lambda d: sm.ContainerStreamer(d, self.chunk_size).send_items(items, total),
            receiver, max_rounds,
        )

    def send_blob(self, blob: bytes, receiver, *, max_rounds: int = 20) -> bool:
        """Regular-mode send of one pre-encoded blob."""
        return self._send(
            lambda d: sm.ObjectStreamer(d, self.chunk_size).send_blob(blob),
            receiver, max_rounds,
        )


class ChaosProxy:
    """Deterministic TCP fault injector between one client and a server.

    Listens on its own port and forwards every accepted connection to
    ``target``, two pump threads per connection (one per direction).
    The fault ``plan`` triggers at an exact byte offset of the faulted
    direction's stream, so a given (plan, traffic) pair always fails at
    the same protocol position — chaos tests are reproducible, and a
    seeded offset (``plan["seed"]`` when ``after_bytes`` is omitted) is
    still a pure function of the plan:

    * ``{"kind": "stall", "after_bytes": N, "stall_s": S}`` — stop
      forwarding the faulted direction for ``S`` seconds at offset ``N``
      (the other direction keeps flowing), then resume losslessly: a
      straggler, not a crash.
    * ``{"kind": "blackhole", "after_bytes": N}`` — forward ``N`` bytes,
      then drop both sockets: the mid-stream death a flaky link causes.
    * ``{"kind": "corrupt", "after_bytes": N, "xor": M}`` — flip the
      byte at offset ``N`` (XOR with ``M``, default 0xFF) and keep
      forwarding: framing survives, payload integrity does not — the
      receiver's crc32/decode stage must catch it.
    * ``{"kind": "throttle", "after_bytes": N, "bps": R}`` — pace the
      faulted direction at ``R`` bytes/second from offset ``N`` on.

    ``direction`` selects the counted stream (``"up"`` = client→server,
    the default; ``"down"`` = server→client). ``triggers`` (default 1)
    arms the fault on that many connections; later connections through
    the same proxy forward untouched, so a client reconnecting after a
    blackhole lands on a clean path — exactly the transient-fault shape
    reconnect-with-backoff must survive.
    """

    def __init__(self, target: tuple, plan: Optional[Mapping[str, Any]] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.target = (str(target[0]), int(target[1]))
        self.plan = dict(plan or {})
        if self.plan and "after_bytes" not in self.plan:
            self.plan["after_bytes"] = random.Random(
                int(self.plan.get("seed", 0))).randrange(1 << 10, 1 << 16)
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._accept_thread: Optional[threading.Thread] = None
        self._threads: list[threading.Thread] = []
        self._socks: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closing = False
        self.connections = 0
        self.triggered = 0

    def start(self) -> "ChaosProxy":
        if self._accept_thread is not None:
            raise RuntimeError("start() already called")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"chaos-accept-{self.address[1]}")
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                csock, _peer = self._srv.accept()
            except OSError:
                return  # listener closed — clean shutdown
            if self._closing:
                csock.close()
                return
            try:
                ssock = socket.create_connection(self.target)
            except OSError:
                csock.close()
                continue
            with self._lock:
                self.connections += 1
                armed = bool(self.plan) and \
                    self.connections <= int(self.plan.get("triggers", 1))
                if armed:
                    self.triggered += 1
                self._socks += [csock, ssock]
            faulted = self.plan.get("direction", "up")
            for src, dst, tag in ((csock, ssock, "up"), (ssock, csock, "down")):
                plan = self.plan if armed and tag == faulted else None
                t = threading.Thread(
                    target=self._pump, args=(src, dst, plan), daemon=True,
                    name=f"chaos-{tag}-{self.address[1]}")
                t.start()
                with self._lock:
                    self._threads.append(t)

    def _pump(self, src: socket.socket, dst: socket.socket,
              plan: Optional[Mapping[str, Any]]) -> None:
        kind = (plan or {}).get("kind")
        after = int((plan or {}).get("after_bytes", 0))
        seen = 0
        fired = False
        kill = False
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                if kind and not fired and seen + len(data) > after:
                    cut = after - seen  # bytes before the fault offset
                    fired = True
                    if kind == "stall":
                        if cut:
                            dst.sendall(data[:cut])
                        time.sleep(float(plan.get("stall_s", 1.0)))
                        dst.sendall(data[cut:])
                    elif kind == "blackhole":
                        if cut:
                            dst.sendall(data[:cut])
                        kill = True
                        break
                    elif kind == "corrupt":
                        flipped = bytearray(data)
                        flipped[cut] ^= int(plan.get("xor", 0xFF)) or 0xFF
                        dst.sendall(bytes(flipped))
                    else:  # throttle: pacing starts at the offset
                        dst.sendall(data)
                        time.sleep(len(data) / float(plan.get("bps", 1e6)))
                elif kind == "throttle" and fired:
                    dst.sendall(data)
                    time.sleep(len(data) / float(plan.get("bps", 1e6)))
                else:
                    dst.sendall(data)
                seen += len(data)
        except OSError:
            kill = True
        if kill:
            # shutdown before close: a plain close is deferred while the
            # opposite pump blocks in recv on the same socket (CPython
            # holds the fd open), so no FIN would reach either peer and
            # the "dead" link would hang everyone until their timeouts.
            # shutdown() takes effect immediately.
            for s in (src, dst):
                with contextlib.suppress(OSError):
                    s.shutdown(socket.SHUT_RDWR)
                with contextlib.suppress(OSError):
                    s.close()
        else:
            # clean EOF: half-close downstream so the opposite pump can
            # keep forwarding until its own side ends
            with contextlib.suppress(OSError):
                dst.shutdown(socket.SHUT_WR)

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            with contextlib.suppress(OSError):
                socket.create_connection(self.address, timeout=1).close()
        self._srv.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        with self._lock:
            socks, threads = list(self._socks), list(self._threads)
        for s in socks:
            with contextlib.suppress(OSError):
                s.shutdown(socket.SHUT_RDWR)  # wake pumps blocked in recv
            with contextlib.suppress(OSError):
                s.close()
        for t in threads:
            t.join(timeout=5)
