"""SFM-style streaming layer (paper §I Fig. 1 and §III).

Mirror of ``src/repro/core/streaming.py``:

* **Frames** — :class:`Chunk`: fixed-size (default 1 MiB) framed slices of
  a logical stream, carrying (stream_id, seq, eof) headers.
* **Drivers** — transport plugins, looked up by name through
  :func:`register_driver`/:func:`make_driver`: :class:`LoopbackDriver`
  (in-process delivery), :class:`FileSpoolDriver` (frames spooled to
  disk, replayed on ``flush()``) and :class:`TCPDriver` (real localhost
  sockets).
* **The federation transport** — :class:`Connection` (JSON control
  frames and raw chunk streams on one socket, a reader that keeps its
  bytes across a timeout), :class:`ConnectionDriver`,
  :class:`StreamDemux` and :class:`TCPServer`, the live plane's
  (:mod:`repro_torch.launch.federation`) accept loop.
* **Streamers** — the three transmission modes with distinct peak-memory
  envelopes (paper Fig. 3): :class:`ObjectStreamer` (*regular*: one
  pre-encoded blob, peak ~ the model, received by :class:`BlobReceiver`),
  :class:`ContainerStreamer` (one encoded dict item at a time, peak ~
  the largest item, reassembled by :class:`ContainerReceiver` into one
  preallocated buffer per item) and :class:`FileStreamer` (a file chunk
  by chunk, peak ~ one chunk, written out by :class:`FileReceiver`).
  :func:`iter_encode_ahead` encodes items ahead of the socket on a
  worker thread (same wire bytes at any depth).
* **ObjectRetriever** — pull mode: the holder registers an object, the
  peer retrieves it over any streamer, with or without a wire pipeline.

Device tensors become host bytes inside the item encoders
(:mod:`repro_torch.core.serialization`), so every segment a driver or
socket sees is host memory; kernels launch on the default stream from
whichever thread encodes.

The layer is zero-copy: items arrive as ordered buffer views, chunkers
slice the views, and loopback delivery hands the segments to the
receiver as they are. Every buffer the layer holds live registers with
the active :class:`~repro_torch.utils.mem.MemoryMeter`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import socket
import struct
import threading
import time
import uuid
from collections.abc import Callable, Iterable, Iterator, Mapping
from typing import Any, Optional, Union

from repro_torch.core import serialization as ser
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import mem

DEFAULT_CHUNK_SIZE = 1 << 20  # 1 MiB, the paper's default

_HDR = struct.Struct("<16sIIB")  # stream_id, seq, payload_len, flags
FLAG_EOF = 1
FLAG_ITEM_END = 2  # container streaming: item boundary marker


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One framed slice of a logical stream.

    ``payload`` is bytes-like **or a tuple of bytes-like segments**
    (scatter-gather: the chunk's wire bytes are the segments'
    concatenation, but nothing is joined until a real transport boundary
    needs contiguity — ``encode()``/``payload_bytes()``). Loopback
    delivery hands the segments to the receiver as-is, so an in-process
    hop moves tensor bytes with zero copies.
    """

    stream_id: bytes          # 16-byte uuid
    seq: int
    payload: Any              # bytes | memoryview | tuple of those
    flags: int = 0

    @property
    def segments(self) -> tuple:
        """The payload as a tuple of bytes-like segments."""
        p = self.payload
        return p if isinstance(p, tuple) else (p,)

    @property
    def nbytes(self) -> int:
        p = self.payload
        if isinstance(p, tuple):
            return sum(len(s) for s in p)
        return len(p)

    def payload_bytes(self) -> bytes:
        """Contiguous payload bytes (joins — records the copy)."""
        p = self.payload
        if isinstance(p, tuple):
            return ser.join_views(list(p))
        if isinstance(p, memoryview):
            mem.record_copy(len(p))
            return bytes(p)
        return bytes(p)

    def encode(self) -> bytes:
        return _HDR.pack(self.stream_id, self.seq, self.nbytes, self.flags) \
            + self.payload_bytes()

    @classmethod
    def decode(cls, buf: bytes) -> Chunk:
        sid, seq, plen, flags = _HDR.unpack_from(buf, 0)
        return cls(sid, seq, buf[_HDR.size : _HDR.size + plen], flags)

    @property
    def eof(self) -> bool:
        return bool(self.flags & FLAG_EOF)

    @property
    def item_end(self) -> bool:
        return bool(self.flags & FLAG_ITEM_END)


# ---------------------------------------------------------------------------
# Drivers (SFM transport plugins)
# ---------------------------------------------------------------------------

class Driver:
    """Transport interface: push chunks, deliver to a registered callback."""

    def connect(self, on_chunk: Callable[[Chunk], None]) -> None:
        self._on_chunk = on_chunk

    def send(self, chunk: Chunk) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Deliver anything the transport still holds (a no-op unless it
        stores and forwards)."""

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


_DRIVERS: dict[str, Callable[..., Driver]] = {}


def register_driver(name: str) -> Callable[[Callable[..., Driver]], Callable[..., Driver]]:
    """Class/factory decorator: bind ``name`` to a transport so job specs
    and :class:`~repro_torch.fl.simulator.SimulationConfig` can select it
    by string — the same registry pattern as
    :func:`repro_torch.core.pipeline.register_stage`."""

    def deco(factory: Callable[..., Driver]) -> Callable[..., Driver]:
        if name in _DRIVERS:
            raise ValueError(f"driver name {name!r} already registered ({_DRIVERS[name]})")
        _DRIVERS[name] = factory
        return factory

    return deco


def registered_drivers() -> tuple[str, ...]:
    return tuple(sorted(_DRIVERS))


#: driver names the reference registers that this package has not ported
NOT_PORTED_DRIVERS: tuple[str, ...] = ()


def make_driver(name: str, **kwargs: Any) -> Driver:
    try:
        factory = _DRIVERS[name]
    except KeyError:
        if name in NOT_PORTED_DRIVERS:
            raise NotImplementedError(
                f"driver {name!r} is not ported to repro_torch yet (ROADMAP A5); "
                f"ported: {registered_drivers()}"
            ) from None
        raise ValueError(
            f"unknown driver {name!r}; registered: {registered_drivers()}"
        ) from None
    return factory(**kwargs)


@register_driver("loopback")
class LoopbackDriver(Driver):
    """Synchronous in-process delivery (the simulator default)."""

    def send(self, chunk: Chunk) -> None:
        self._on_chunk(chunk)


@register_driver("spool")
class FileSpoolDriver(Driver):
    """Spools every frame to a directory, then replays on ``flush()``.

    Models a store-and-forward relay; also exercises frame encode/decode.
    Frame filenames carry a per-driver unique prefix, so drivers can
    share one spool directory.
    """

    def __init__(self, spool_dir: str) -> None:
        self.spool_dir = spool_dir
        os.makedirs(spool_dir, exist_ok=True)
        self._uid = uuid.uuid4().hex
        self._count = 0

    def _path(self, i: int) -> str:
        return os.path.join(self.spool_dir, f"{self._uid}-{i:08d}.frame")

    def send(self, chunk: Chunk) -> None:
        with open(self._path(self._count), "wb") as fh:
            fh.write(chunk.encode())
        self._count += 1

    def flush(self) -> None:
        for i in range(self._count):
            path = self._path(i)
            with open(path, "rb") as fh:
                self._on_chunk(Chunk.decode(fh.read()))
            os.unlink(path)
        self._count = 0


@register_driver("tcp")
class TCPDriver(Driver):
    """Real localhost sockets: sender connects to a receiver thread.

    Demonstrates SFM's driver-swap claim — the streamers run unchanged
    over TCP instead of loopback.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()

    def connect(self, on_chunk: Callable[[Chunk], None]) -> None:
        super().connect(on_chunk)

        def serve() -> None:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                # server socket closed before any sender connected —
                # a clean no-traffic shutdown, not an error
                self._done.set()
                return
            with conn:
                fh = conn.makefile("rb")
                while True:
                    hdr = fh.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    sid, seq, plen, flags = _HDR.unpack(hdr)
                    tr = obs_trace.ACTIVE
                    if tr is None:
                        payload = fh.read(plen)
                        chunk = Chunk(sid, seq, payload, flags)
                        self._on_chunk(chunk)
                    else:
                        with tr.span("tcp.recv", "net", nbytes=plen, seq=seq):
                            payload = fh.read(plen)
                            chunk = Chunk(sid, seq, payload, flags)
                            self._on_chunk(chunk)
                    if chunk.eof:
                        break
            self._done.set()

        self._thread = threading.Thread(target=serve, daemon=True)
        self._thread.start()

    #: below this many payload bytes a chunk is joined into one buffer
    #: before hitting the socket (small-write coalescing: one syscall and
    #: one TCP segment beat a scatter-gather call over tiny pieces).
    #: Per-socket senders raise this to the socket's actual SO_SNDBUF
    #: (see :func:`socket_coalesce_bytes`) — writes smaller than the
    #: kernel send buffer complete in one copy anyway, so gathering only
    #: pays off past it.
    COALESCE_BYTES = 1 << 13

    def send(self, chunk: Chunk) -> None:
        tr = obs_trace.ACTIVE
        if tr is None:
            self._send(chunk)
            return
        coalesce = self._coalesce or self.COALESCE_BYTES
        gather = chunk.nbytes >= coalesce and hasattr(socket.socket, "sendmsg")
        with tr.span("tcp.send", "net", nbytes=chunk.nbytes,
                     segments=len(chunk.segments), gather=gather):
            self._send(chunk)

    _coalesce: Optional[int] = None

    def _send(self, chunk: Chunk) -> None:
        if self._sock is None:
            self._sock = socket.create_connection(self.address)
            self._coalesce = socket_coalesce_bytes(self._sock)
        send_chunk(self._sock, chunk, self._coalesce)

    def close(self) -> None:
        """Idempotent shutdown: drains the receiver thread even when no
        sender ever connected (the concurrent scheduler closes drivers on
        every path, including dropped-out round trips)."""
        if self._sock is not None:
            self._sock.close()
            self._sock = None
            self._done.wait(timeout=30)
        elif self._thread is not None and not self._done.is_set():
            # no sender ever connected: wake the blocked accept() with an
            # empty connection so the receiver thread can exit promptly
            try:
                socket.create_connection(self.address, timeout=1).close()
            except OSError:
                pass
            self._done.wait(timeout=5)
        self._srv.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# Real federation transport: shared frame I/O + the concurrent server plane
# ---------------------------------------------------------------------------

#: never coalesce past this, whatever SO_SNDBUF claims — joining a huge
#: chunk in user space just to hand the kernel one buffer wastes the
#: copy the scatter-gather path exists to avoid
COALESCE_CAP = 1 << 16


def socket_coalesce_bytes(sock: socket.socket) -> int:
    """SO_SNDBUF-aware small-write coalescing threshold for ``sock``.

    A write smaller than the kernel's send buffer is absorbed in one
    copy regardless, so scatter-gather only wins once a chunk outgrows
    it; below that, one joined ``sendall`` is one syscall and one TCP
    segment. Clamped to [``TCPDriver.COALESCE_BYTES``, ``COALESCE_CAP``]
    so a giant SO_SNDBUF can't reintroduce full-chunk user-space joins.
    """
    try:
        sndbuf = sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)
    except OSError:  # pragma: no cover - exotic socket object
        return TCPDriver.COALESCE_BYTES
    return max(TCPDriver.COALESCE_BYTES, min(int(sndbuf), COALESCE_CAP))


def send_chunk(sock: socket.socket, chunk: Chunk,
               coalesce: Optional[int] = None) -> None:
    """Write one frame to ``sock``: header + payload segments.

    The single chunk-egress path shared by :class:`TCPDriver` and the
    federation server plane: small chunks are coalesced into one
    ``sendall`` (threshold from :func:`socket_coalesce_bytes`), large
    chunks go out as a kernel scatter-gather ``sendmsg`` over the
    payload views with partial-send resume — no user-space join of the
    tensor bytes, identical bytes on the wire either way.
    """
    if coalesce is None:
        coalesce = TCPDriver.COALESCE_BYTES
    hdr = _HDR.pack(chunk.stream_id, chunk.seq, chunk.nbytes, chunk.flags)
    if chunk.nbytes < coalesce or not hasattr(sock, "sendmsg"):
        # small-write coalescing — and the portable fallback where the
        # platform has no scatter-gather socket call (Windows)
        sock.sendall(hdr + chunk.payload_bytes())
        return
    bufs: list[Any] = [hdr, *chunk.segments]
    while bufs:
        sent = sock.sendmsg(bufs)
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent and bufs:
            bufs[0] = memoryview(bufs[0])[sent:]


#: control frames are length-prefixed JSON; anything bigger than this is
#: a corrupted stream, not a plausible control message
CTRL_MAX_BYTES = 1 << 20

_CTRL = struct.Struct("<I")


class ProtocolError(ValueError):
    """A peer sent bytes that violate the federation wire protocol."""


class Connection:
    """One established federation socket, either end.

    Two frame vocabularies interleave on the stream, demarcated by
    protocol state (each control frame says what follows):

    * **control frames** — u32 LE length + JSON body (handshake, round
      control, grants);
    * **chunk streams** — raw :class:`Chunk` frames, byte-identical to
      the point-to-point :class:`TCPDriver` wire, ending at a
      ``FLAG_EOF`` chunk.

    Reads go through one buffered reader; writes serialize on a lock so
    a control frame can never tear through the middle of a chunk
    stream when helper threads share the connection. Chunk egress uses
    the same gather/coalesce path as :class:`TCPDriver`
    (:func:`send_chunk`), with the coalescing threshold adapted to this
    socket's ``SO_SNDBUF``.

    The reader is **timeout-safe**: bytes received before a socket
    timeout stay in the connection's own buffer, and the next read
    resumes at the exact byte position — unlike ``socket.makefile``,
    whose internal buffer is undefined after a timeout. The federation
    server leans on this to *drain* a straggler's late uplink after a
    grace deadline fired mid-frame: the drain picks up where the granted
    read stopped, so leftover bytes never desync the frame stream.
    """

    def __init__(self, sock: socket.socket,
                 peer: Optional[tuple] = None) -> None:
        self.sock = sock
        try:
            self.peer = peer or sock.getpeername()
        except OSError:  # pragma: no cover - already-dead socket
            self.peer = peer or ("?", 0)
        self._rbuf = bytearray()
        # frame-resumption state: a parsed-but-unsatisfied length prefix
        # (control) or chunk header survives a mid-payload timeout, so
        # the next read completes the *same* frame instead of parsing
        # payload bytes as a fresh header
        self._ctrl_pending: Optional[int] = None
        self._chunk_pending: Optional[tuple] = None
        self._coalesce = socket_coalesce_bytes(sock)
        self._wlock = threading.Lock()

    def settimeout(self, timeout: Optional[float]) -> None:
        self.sock.settimeout(timeout)

    # -- control frames -----------------------------------------------------
    def send_ctrl(self, obj: Mapping[str, Any]) -> None:
        body = json.dumps(obj, sort_keys=True).encode()
        with self._wlock:
            self.sock.sendall(_CTRL.pack(len(body)) + body)

    def recv_ctrl(self) -> dict[str, Any]:
        if self._ctrl_pending is None:
            (n,) = _CTRL.unpack(self._read_exact(_CTRL.size))
            if n > CTRL_MAX_BYTES:
                raise ProtocolError(
                    f"control frame declares {n} bytes (max {CTRL_MAX_BYTES}); "
                    "stream is corrupt or the peer speaks a different protocol"
                )
            self._ctrl_pending = n
        body = self._read_exact(self._ctrl_pending)
        self._ctrl_pending = None
        try:
            return json.loads(body)
        except json.JSONDecodeError as exc:
            raise ProtocolError(f"control frame is not JSON: {exc}") from None

    # -- chunk streams ------------------------------------------------------
    def send_chunk(self, chunk: Chunk) -> None:
        with self._wlock:
            send_chunk(self.sock, chunk, self._coalesce)

    def recv_chunk(self) -> Chunk:
        if self._chunk_pending is None:
            hdr = self._read_exact(_HDR.size)
            self._chunk_pending = _HDR.unpack(hdr)
        sid, seq, plen, flags = self._chunk_pending
        tr = obs_trace.ACTIVE
        if tr is None:
            payload = self._read_exact(plen)
        else:
            with tr.span("tcp.recv", "net", nbytes=plen, seq=seq):
                payload = self._read_exact(plen)
        self._chunk_pending = None
        return Chunk(sid, seq, payload, flags)

    def recv_stream(self, on_chunk: Callable[[Chunk], None]) -> int:
        """Receive chunk frames into ``on_chunk`` until a ``FLAG_EOF``
        chunk closes the stream; returns total wire bytes (headers
        included). Chunks are routed by their own ``stream_id``, so a
        multiplexing peer may interleave frames of several logical
        streams — this call returns when the *first-seen* stream ends
        (others keep routing through the same callback via
        :class:`StreamDemux` on the caller's side if needed)."""
        total = 0
        sid: Optional[bytes] = None
        while True:
            chunk = self.recv_chunk()
            total += _HDR.size + chunk.nbytes
            if sid is None:
                sid = chunk.stream_id
            on_chunk(chunk)
            if chunk.eof and chunk.stream_id == sid:
                return total

    def _read_exact(self, n: int) -> bytes:
        # a TimeoutError from recv propagates with every byte received so
        # far retained in _rbuf — the next call resumes mid-frame
        buf = self._rbuf
        while len(buf) < n:
            try:
                got = self.sock.recv(max(n - len(buf), 1 << 16))
            except InterruptedError:  # pragma: no cover - EINTR
                continue
            if not got:
                raise ConnectionError(
                    f"peer {self.peer} closed the connection mid-frame "
                    f"(wanted {n} bytes, got {len(buf)})"
                )
            buf += got
        out = bytes(memoryview(buf)[:n])
        del buf[:n]
        return out

    def close(self) -> None:
        # shutdown first: close() alone is deferred while another thread
        # blocks in recv on this socket (CPython keeps the fd referenced),
        # so dropping a client mid-read would neither wake our reader nor
        # send the peer a FIN until some timeout fired
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:  # pragma: no cover
            pass


class ConnectionDriver(Driver):
    """Send-side :class:`Driver` over an established :class:`Connection`,
    so the standard streamers (:class:`ContainerStreamer`, ...) run
    unchanged over a long-lived multiplexed federation socket instead of
    a per-transfer point-to-point one. Counts egress frame bytes like
    the simulator's CountingDriver (headers included)."""

    def __init__(self, conn: Connection) -> None:
        self.conn = conn
        self.bytes_sent = 0

    def send(self, chunk: Chunk) -> None:
        self.bytes_sent += _HDR.size + chunk.nbytes
        tr = obs_trace.ACTIVE
        if tr is None:
            self.conn.send_chunk(chunk)
            return
        with tr.span("tcp.send", "net", nbytes=chunk.nbytes,
                     segments=len(chunk.segments)):
            self.conn.send_chunk(chunk)

    def close(self) -> None:
        # the connection outlives one logical stream — never closed here
        pass


class StreamDemux:
    """Connection multiplexing: routes interleaved chunk frames to
    per-stream receivers keyed by the frame's own ``stream_id``.

    ``receiver_factory(stream_id)`` builds the receiver for a stream's
    first chunk; :meth:`route` feeds every chunk to its stream's
    receiver and returns the finished receiver when an EOF frame closes
    a stream (``None`` otherwise). One connection can therefore carry
    several logical transfers at once — the federation server's uplink
    plane and any future bidirectional traffic share this primitive.
    """

    def __init__(self, receiver_factory: Callable[[bytes], Any]) -> None:
        self._factory = receiver_factory
        self._live: dict[bytes, Any] = {}

    @property
    def open_streams(self) -> int:
        return len(self._live)

    def route(self, chunk: Chunk) -> Optional[Any]:
        recv = self._live.get(chunk.stream_id)
        if recv is None:
            recv = self._factory(chunk.stream_id)
            self._live[chunk.stream_id] = recv
        recv.on_chunk(chunk)
        if chunk.eof:
            return self._live.pop(chunk.stream_id)
        return None


class TCPServer:
    """Concurrent accept loop: the real-deployment listener grown from
    the point-to-point :class:`TCPDriver`.

    Every accepted socket becomes a :class:`Connection` handed to
    ``on_connection`` on its own daemon thread, so hundreds of clients
    can be in handshake or mid-stream simultaneously while the owner
    (the federation server) drives round logic. Frames, gather writes
    and coalescing are byte-identical to the driver wire — a client
    cannot tell which end it speaks to.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backlog: int = 128) -> None:
        self._srv = socket.create_server((host, port), backlog=backlog)
        self.address = self._srv.getsockname()
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._closing = False
        self.accepted = 0

    def serve(self, on_connection: Callable[[Connection], None]) -> None:
        """Start accepting; each connection runs ``on_connection(conn)``
        on a dedicated thread. Idempotent close via :meth:`close`."""
        if self._accept_thread is not None:
            raise RuntimeError("serve() already called")

        def accept_loop() -> None:
            while True:
                try:
                    sock, peer = self._srv.accept()
                except OSError:
                    return  # listener closed — clean shutdown
                if self._closing:
                    sock.close()  # the close() wake-up self-connection
                    return
                conn = Connection(sock, peer)
                with self._lock:
                    self.accepted += 1
                    t = threading.Thread(
                        target=on_connection, args=(conn,), daemon=True,
                        name=f"fed-conn-{peer[1]}",
                    )
                    self._conn_threads.append(t)
                t.start()

        self._accept_thread = threading.Thread(
            target=accept_loop, daemon=True, name="fed-accept"
        )
        self._accept_thread.start()

    def close(self) -> None:
        # closing the listener fd does NOT wake a thread blocked in
        # accept() on Linux — it would sit out the whole join timeout.
        # shutdown() does; where a platform refuses shutdown on a
        # listener, a throwaway self-connection unblocks it instead.
        self._closing = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            try:
                socket.create_connection(self.address, timeout=1).close()
            except OSError:
                pass
        self._srv.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        with self._lock:
            threads = list(self._conn_threads)
        for t in threads:
            t.join(timeout=5)



# ---------------------------------------------------------------------------
# Receivers (re-assembly with mode-specific memory envelopes)
# ---------------------------------------------------------------------------

class _ItemAssembler:
    """Reassembles one logical item from in-order chunk segments into a
    **single preallocated buffer**.

    The first segments are buffered (zero-copy references) only until
    the item's own header — u32 header length + JSON header — can be
    parsed; :func:`repro_torch.core.serialization.declared_item_nbytes` then
    gives the item's total wire length and a ``bytearray`` of exactly
    that size is allocated once. Every further segment is copied
    straight into it at its offset, so a multi-chunk item costs one
    buffer and one copy instead of the old parts-list + ``b"".join``
    double copy. Single-segment items (item smaller than a chunk — the
    common case) are handed to the decoder as the received view, with
    no copy and no allocation at all.

    MemoryMeter accounting matches the single-buffer reality: one
    ``record_alloc`` for the assembled buffer (plus the transient
    pre-header segments), one ``record_free`` when the item is consumed.
    """

    __slots__ = ("_parts", "_parts_n", "_buf", "_filled", "_total")

    def __init__(self) -> None:
        self._parts: list = []
        self._parts_n = 0
        self._buf: Optional[bytearray] = None
        self._filled = 0
        self._total: Optional[int] = None

    @property
    def nbytes(self) -> int:
        """Live receive-buffer bytes held for the in-flight item."""
        return self._parts_n + (self._total or 0)

    def add(self, seg: Any, more_coming: bool = True) -> None:
        """One in-order segment of the current item. ``more_coming=False``
        marks segments of the item's final chunk: an item that completes
        before its header was ever parsed skips preallocation entirely —
        the common single-chunk item is handed to the decoder as the
        received view, zero-parse and zero-copy."""
        n = len(seg)
        if n == 0:
            return
        if self._buf is not None:
            if self._filled + n > self._total:
                raise ValueError(
                    f"item overflows its declared wire length {self._total} "
                    f"({self._filled + n} bytes received)"
                )
            self._buf[self._filled:self._filled + n] = seg
            mem.record_copy(n)
            self._filled += n
            return
        self._parts.append(seg)
        self._parts_n += n
        mem.record_alloc(n)
        if more_coming:
            self._try_prealloc()

    def _peek_prefix(self, n: int) -> bytes:
        out = bytearray()
        for p in self._parts:
            out += memoryview(p)[: n - len(out)]
            if len(out) >= n:
                break
        return bytes(out)

    def _try_prealloc(self) -> None:
        if self._parts_n < 4:
            return
        total = ser.declared_item_nbytes(
            self._parts[0] if len(self._parts) == 1
            else self._peek_prefix(min(self._parts_n, 4096))
        )
        if total is None or self._parts_n >= total:
            # header not parseable yet, or the item is already complete
            # in the buffered segments (no copy needed at all)
            return
        self._total = total
        self._buf = bytearray(total)
        mem.record_alloc(total)
        for p in self._parts:
            self._buf[self._filled:self._filled + len(p)] = p
            mem.record_copy(len(p))
            self._filled += len(p)
        mem.record_free(self._parts_n)
        self._parts.clear()
        self._parts_n = 0

    def complete(self) -> tuple[Any, int]:
        """Finish the item: returns ``(buffer, live_bytes)`` — the
        assembled bytes-like to decode from, and the metered bytes the
        caller must ``record_free`` once the decoded item is consumed."""
        if self._buf is not None:
            if self._filled != self._total:
                raise ValueError(
                    f"item ended at {self._filled} bytes but its header "
                    f"declared {self._total}"
                )
            out: Any = memoryview(self._buf)
            live = self._total
        elif len(self._parts) == 1:
            out, live = self._parts[0], self._parts_n
        elif self._parts:
            # unjoined scatter-gather parts: the decoders are
            # segment-aware (header from the leading segment,
            # ``frombuffer`` per payload segment), so a single-chunk
            # item keeps the sender's segment structure end to end —
            # no receive-side join, no copy
            out = list(self._parts)
            live = self._parts_n
        else:
            out, live = b"", 0
        self._parts = []
        self._parts_n = 0
        self._buf = None
        self._filled = 0
        self._total = None
        return out, live


class BlobReceiver:
    """Regular transmission receiver: accumulates the whole blob.

    Chunk segments are held by reference (zero-copy) and joined exactly
    once when EOF arrives — the single materialization the regular mode
    is defined by. ``decode_container`` turns the blob into the result
    dict; the default is the plain serialization codec, and the wire
    pipeline substitutes its envelope-aware decoder.
    """

    def __init__(
        self,
        decode_container: Optional[Callable[[bytes], dict[str, Any]]] = None,
    ) -> None:
        self._parts: list = []
        self._size = 0
        self._decode = decode_container or ser.deserialize_container
        self.result: Optional[dict[str, Any]] = None

    def on_chunk(self, chunk: Chunk) -> None:
        self._parts.extend(chunk.segments)
        mem.record_alloc(chunk.nbytes)
        self._size += chunk.nbytes
        if chunk.eof:
            blob = b"".join(self._parts)
            mem.record_copy(len(blob))
            mem.record_alloc(len(blob))  # the one materialized copy
            self.result = self._decode(blob)
            mem.record_free(len(blob) + self._size)
            self._parts.clear()


class ContainerReceiver:
    """Container-streaming receiver: holds at most one item's bytes,
    reassembled into a single preallocated buffer (see
    :class:`_ItemAssembler`).

    ``consume`` receives each (name, value) as soon as its item completes
    — enabling *incremental* downstream processing (e.g. streaming FedAvg)
    without ever materializing the full dict. If ``consume`` is omitted the
    items are collected into ``result`` (arrays themselves must live
    somewhere; the *transmission* overhead stays one item).

    ``decode_item`` turns one reassembled item's buffer into ``(name,
    value, consumed)``; the default is the plain serialization codec, and
    the wire pipeline substitutes its envelope-aware decoder — stage
    decode then runs here, inside the streaming loop. Decoded arrays are
    ``frombuffer`` views into the assembled buffer (no decode copy).
    """

    def __init__(
        self,
        consume: Optional[Callable[[str, Any], None]] = None,
        decode_item: Optional[Callable[[bytes], tuple[str, Any, int]]] = None,
    ) -> None:
        self._asm = _ItemAssembler()
        self._consume = consume
        self._decode = decode_item or ser.deserialize_item
        self.result: dict[str, Any] = {}
        self.done = False

    def on_chunk(self, chunk: Chunk) -> None:
        for seg in chunk.segments:
            self._asm.add(seg, more_coming=not chunk.item_end)
        if chunk.item_end:
            buf, live = self._asm.complete()
            name, value, _ = self._decode(buf)
            if self._consume is not None:
                self._consume(name, value)
            else:
                self.result[name] = value
            mem.record_free(live)
        if chunk.eof:
            self.done = True


class FileReceiver:
    """File-streaming receiver: writes each chunk straight to disk."""

    def __init__(self, out_path: str) -> None:
        self.out_path = out_path
        self._fh = open(out_path, "wb")
        self.done = False

    def on_chunk(self, chunk: Chunk) -> None:
        with mem.record_hold(chunk.nbytes):
            for seg in chunk.segments:
                self._fh.write(seg)
        if chunk.eof:
            self._fh.close()
            self.done = True


# ---------------------------------------------------------------------------
# Streamers (senders)
# ---------------------------------------------------------------------------

def _chunk_iter(blob: bytes, chunk_size: int) -> Iterator[tuple[Any, bool]]:
    """Slice a contiguous blob into chunk payloads — memoryview slices,
    so chunking copies nothing."""
    mv = memoryview(blob)
    for off in range(0, len(blob), chunk_size):
        part = mv[off : off + chunk_size]
        yield part, off + chunk_size >= len(blob)
    if not blob:
        yield b"", True


def _chunk_iter_views(item: ser.ViewsLike, chunk_size: int) -> Iterator[tuple[Any, bool]]:
    """Chunk one scatter-gather item into payloads of exactly
    ``chunk_size`` bytes (except the last) **without joining**: each
    chunk payload is a single view or a tuple of views sliced from the
    item's segments. Chunk boundaries are byte-identical to slicing the
    joined item, so the wire format is unchanged."""
    total = ser.views_nbytes(item)
    if total == 0:
        yield b"", True
        return
    cur: list = []
    cur_n = 0
    emitted = 0
    for seg in ser.iter_view_segments(item):
        off = 0
        n = seg.nbytes
        while off < n:
            take = min(chunk_size - cur_n, n - off)
            cur.append(seg if take == n and off == 0 else seg[off:off + take])
            cur_n += take
            off += take
            if cur_n == chunk_size:
                emitted += chunk_size
                yield (cur[0] if len(cur) == 1 else tuple(cur)), emitted >= total
                cur = []
                cur_n = 0
    if cur_n:
        yield (cur[0] if len(cur) == 1 else tuple(cur)), True


# ---------------------------------------------------------------------------
# Encode-ahead (compute/IO overlap)
# ---------------------------------------------------------------------------

#: default encode-ahead depth for senders on real-IO transports (TCP,
#: the live-federation connection). 0 disables lookahead entirely — the
#: classic fully-sequential encode->send loop. Override per process
#: with ``REPRO_WIRE_PREFETCH``.
DEFAULT_ENCODE_AHEAD = int(os.environ.get("REPRO_WIRE_PREFETCH", "2"))

#: adaptive ceiling: queue memory is ~depth encoded items, so unbounded
#: growth would trade the container envelope's O(item) peak for latency
MAX_ENCODE_AHEAD = 8

_EA_DONE = object()


class AdaptiveEncodeAhead:
    """Adaptive depth controller for :func:`iter_encode_ahead`.

    Starts at :data:`DEFAULT_ENCODE_AHEAD` and grows by one — never past
    ``max_depth``, never below the default — each time a completed
    transfer's observed sender stall fraction (the ``wire.encode_wait_us``
    time the send loop spent starved, over the transfer's wall time)
    exceeds ``grow_threshold``: the encoder, not the socket, is the
    bottleneck, so a deeper lookahead buys real overlap. When the sender
    never starves the depth stays put — lookahead memory is ~depth
    encoded items and there is nothing to win.

    Depth only changes *between* transfers (each ``send_items`` reads it
    once), and every depth produces bitwise-identical wire bytes, so
    adaptation is invisible to the receiver. Thread-safe: one controller
    may be shared by several sender threads.
    """

    def __init__(self, depth: Optional[int] = None,
                 max_depth: int = MAX_ENCODE_AHEAD,
                 grow_threshold: float = 0.10) -> None:
        self._depth = DEFAULT_ENCODE_AHEAD if depth is None else int(depth)
        self.max_depth = int(max_depth)
        self.grow_threshold = float(grow_threshold)
        self.grown = 0
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def observe(self, stall_s: float, wall_s: float) -> None:
        """Feed one completed transfer's total sender stall + wall time."""
        if wall_s <= 0.0:
            return
        with self._lock:
            if (stall_s / wall_s > self.grow_threshold
                    and self._depth < self.max_depth):
                self._depth += 1
                self.grown += 1
                depth = self._depth
            else:
                return
        reg = obs_metrics.ACTIVE
        if reg is not None:
            reg.gauge("wire.encode_ahead_depth").max(depth)


def iter_encode_ahead(
    items: Iterable[tuple[str, ser.ViewsLike]], depth: int,
    stall_sink: Optional[Callable[[float], None]] = None,
) -> Iterator[tuple[str, ser.ViewsLike]]:
    """Bounded-depth encode-ahead over a ``(name, item)`` encode iterator.

    A background thread drives the underlying iterator **strictly in
    order** — stateful stages (``delta``, ``crc32``, error-feedback
    quantize) observe items exactly as they would without lookahead —
    at most ``depth`` items ahead of the consumer. While the sender
    blocks in ``sendmsg`` for item k (a syscall that releases the GIL),
    the worker encodes item k+1, and a quantize it launched on the
    card's default stream keeps computing. The same items flow to the
    consumer in the same order, so wire bytes are bitwise-identical to
    the sequential loop (pinned by the golden-hash suite).

    Queued items register with the active :class:`~repro_torch.utils.mem.
    MemoryMeter` — they *are* live bytes — so the container envelope
    honestly reports the ~(1 + depth)-item peak the lookahead trades
    for overlap. Worker exceptions re-raise at the consumer; abandoning
    the iterator stops the worker promptly.

    Telemetry (when active): a ``wire.encode_wait_us`` histogram of
    sender stall time per item, a ``wire.encode_ahead_depth`` gauge,
    and ``wire.encode_ahead`` / ``wire.encode_wait`` spans on the
    worker / sender threads so a Perfetto trace shows encode-of-k+1
    overlapping tcp.send-of-k. ``stall_sink`` receives the same
    per-item sender-stall seconds the histogram observes, with no
    registry required — :class:`AdaptiveEncodeAhead` feeds on it.
    """
    if depth <= 0:
        yield from items
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []

    def _put(entry: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def pump() -> None:
        it = iter(items)
        try:
            while True:
                tr = obs_trace.ACTIVE
                if tr is None:
                    got = next(it, _EA_DONE)
                else:
                    with tr.span("wire.encode_ahead", "wire"):
                        got = next(it, _EA_DONE)
                if got is _EA_DONE:
                    return
                name, item = got
                nbytes = ser.views_nbytes(item)
                mem.record_alloc(nbytes)
                if not _put((name, item, nbytes)):
                    mem.record_free(nbytes)
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised at the consumer
            err.append(exc)
        finally:
            _put(_EA_DONE)

    worker = threading.Thread(target=pump, daemon=True,
                              name="wire-encode-ahead")
    worker.start()
    reg = obs_metrics.ACTIVE
    if reg is not None:
        reg.gauge("wire.encode_ahead_depth").max(depth)
    try:
        while True:
            tr = obs_trace.ACTIVE
            t0 = time.perf_counter()
            if tr is None:
                got = q.get()
            else:
                with tr.span("wire.encode_wait", "wire"):
                    got = q.get()
            if got is _EA_DONE:
                break
            wait_s = time.perf_counter() - t0
            reg = obs_metrics.ACTIVE
            if reg is not None:
                reg.histogram("wire.encode_wait_us").observe(wait_s * 1e6)
            if stall_sink is not None:
                stall_sink(wait_s)
            name, item, nbytes = got
            try:
                yield name, item
            finally:
                mem.record_free(nbytes)
    finally:
        stop.set()
        # join before draining: a put already in flight when the stop
        # flag was set may still land an item in the queue (the worker
        # re-checks stop only between put attempts), and items drained
        # must stop arriving before the drain runs or their metered
        # bytes leak
        worker.join(timeout=10.0)
        try:
            while True:
                got = q.get_nowait()
                if got is not _EA_DONE:
                    mem.record_free(got[2])
        except queue.Empty:
            pass
        if err:
            raise err[0]



class ObjectStreamer:
    """Regular transmission: whole container encoded, then chunked."""

    def __init__(self, driver: Driver, chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
        self.driver = driver
        self.chunk_size = chunk_size

    def send_blob(self, blob: bytes) -> bytes:
        """Chunk out an already-encoded blob (the caller registered its
        allocation; the streamer frees it once fully sent)."""
        sid = uuid.uuid4().bytes
        seq = 0
        for part, last in _chunk_iter(blob, self.chunk_size):
            self.driver.send(Chunk(sid, seq, part, FLAG_EOF if last else 0))
            seq += 1
        mem.record_free(len(blob))
        return sid

    def send_container(self, sd: Mapping[str, Any]) -> bytes:
        return self.send_blob(ser.serialize_container(sd))  # registers full-blob alloc


class ContainerStreamer:
    """Paper §III: transmit **one parameter-dict item at a time**.

    ``prefetch`` enables bounded-depth encode-ahead
    (:func:`iter_encode_ahead`): a worker thread encodes up to that many
    items past the one currently on the wire, overlapping quantize
    dispatch with socket writes. 0 (the default) keeps the classic
    fully-sequential loop — in-process loopback delivery has no IO to
    overlap, so only real-transport senders (the TCP driver, the live
    federation plane) opt in, typically at
    :data:`DEFAULT_ENCODE_AHEAD`. Passing an
    :class:`AdaptiveEncodeAhead` controller instead of an int reads the
    depth per transfer and feeds the observed sender stalls back, so
    repeated sends (the federation round loop) deepen the lookahead
    only when the encoder is the measured bottleneck.
    """

    def __init__(self, driver: Driver, chunk_size: int = DEFAULT_CHUNK_SIZE,
                 prefetch: Union[int, "AdaptiveEncodeAhead"] = 0) -> None:
        self.driver = driver
        self.chunk_size = chunk_size
        self.prefetch = prefetch

    def send_items(self, items: Iterable[tuple[str, ser.ViewsLike]], total: int) -> bytes:
        """Stream ``total`` pre-encoded items, framing item boundaries.

        The item source is any (name, item) iterator — the plain
        serialization codec or a wire pipeline's envelope encoder — and
        is consumed lazily, so peak live bytes stays ~one encoded item
        (~1 + ``prefetch`` items with encode-ahead on). Each item may be
        contiguous bytes or a scatter-gather view list
        (:data:`repro_torch.core.serialization.Views`); views flow through to
        the driver unjoined.
        """
        adaptive = (self.prefetch
                    if isinstance(self.prefetch, AdaptiveEncodeAhead) else None)
        depth = adaptive.depth if adaptive is not None else self.prefetch
        stall = [0.0]
        if depth > 0:
            sink = None
            if adaptive is not None:
                def sink(s: float, _acc=stall) -> None:
                    _acc[0] += s
            items = iter_encode_ahead(items, depth, stall_sink=sink)
        t0 = time.perf_counter() if adaptive is not None else 0.0
        sid = uuid.uuid4().bytes
        seq = 0
        for i, (_name, item) in enumerate(items):
            last_item = i == total - 1
            for part, item_last in _chunk_iter_views(item, self.chunk_size):
                flags = 0
                if item_last:
                    flags |= FLAG_ITEM_END
                    if last_item:
                        flags |= FLAG_EOF
                self.driver.send(Chunk(sid, seq, part, flags))
                seq += 1
        if adaptive is not None:
            adaptive.observe(stall[0], time.perf_counter() - t0)
        return sid

    def send_container(self, sd: Mapping[str, Any]) -> bytes:
        return self.send_items(ser.iter_serialized_items(sd), len(sd))


class FileStreamer:
    """Paper §III: stream a file chunk-by-chunk (peak memory = chunk)."""

    def __init__(self, driver: Driver, chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
        self.driver = driver
        self.chunk_size = chunk_size

    def send_file(self, path: str) -> bytes:
        sid = uuid.uuid4().bytes
        size = os.path.getsize(path)
        seq = 0
        sent = 0
        with open(path, "rb") as fh:
            while True:
                part = fh.read(self.chunk_size)
                sent += len(part)
                last = sent >= size or not part
                with mem.record_hold(len(part)):
                    self.driver.send(Chunk(sid, seq, part, FLAG_EOF if last else 0))
                seq += 1
                if last:
                    break
        return sid


# ---------------------------------------------------------------------------
# ObjectRetriever (pull-mode, paper contribution 2)
# ---------------------------------------------------------------------------

class _ConsumeSink:
    """Adapts a plain ``consume(name, value)`` callback onto the
    streaming-sink protocol the wire decoder drives."""

    def __init__(self, consume: Callable[[str, Any], None]) -> None:
        self._consume = consume

    def begin(self, meta: Mapping[str, Any]) -> float:
        return float(meta.get("num_samples", 1))

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        self._consume(name, value)


class ObjectRetriever:
    """Holder registers objects; peers retrieve them by id over a chosen

    streaming mode. This is the integration surface existing workflows use
    without restructuring their code around push-streaming callbacks.

    Pull-mode transfers take the same transform stack as the push wire:
    pass a :class:`~repro_torch.core.pipeline.WirePipeline` (at construction or
    per ``retrieve``) and every container item runs the stage encode
    hooks on the holder side and the stage decode hooks on the retriever
    side, *inside* the streaming loop — a quantized+compressed pull peaks
    at ~one item, exactly like the push path. ``consume`` (incremental
    per-item delivery) and ``sink`` (the streaming-aggregator
    ``begin``/``accept_item`` protocol) both compose with a pipeline.
    """

    def __init__(self, chunk_size: int = DEFAULT_CHUNK_SIZE,
                 pipeline: Optional[Any] = None) -> None:
        self.chunk_size = chunk_size
        self.pipeline = pipeline
        self._registry: dict[str, tuple[str, Any]] = {}

    def register_container(self, obj_id: str, sd: Mapping[str, Any]) -> str:
        self._registry[obj_id] = ("container", sd)
        return obj_id

    def register_file(self, obj_id: str, path: str) -> str:
        self._registry[obj_id] = ("file", path)
        return obj_id

    def retrieve(
        self,
        obj_id: str,
        driver: Optional[Driver] = None,
        mode: str = "container",
        out_path: Optional[str] = None,
        consume: Optional[Callable[[str, Any], None]] = None,
        pipeline: Optional[Any] = None,
        sink: Optional[Any] = None,
    ) -> Any:
        kind, obj = self._registry[obj_id]
        driver = driver or LoopbackDriver()
        pipeline = pipeline if pipeline is not None else self.pipeline
        if consume is not None and sink is not None:
            raise ValueError("pass either consume= or sink=, not both")
        if kind == "file":
            if pipeline is not None:
                raise ValueError(
                    "file retrieval streams raw chunks; per-item pipeline "
                    "stages apply to container retrievals only"
                )
            assert out_path is not None, "file retrieval needs out_path"
            receiver: Any = FileReceiver(out_path)
            driver.connect(receiver.on_chunk)
            FileStreamer(driver, self.chunk_size).send_file(obj)
            driver.close()
            return out_path
        if pipeline is not None:
            return self._retrieve_pipelined(obj, driver, mode, pipeline, consume, sink)
        if mode != "container" and (consume is not None or sink is not None):
            raise ValueError(
                "regular (blob) retrieval reassembles the whole container; "
                "incremental consume=/sink= delivery needs mode='container'"
            )
        if sink is not None:
            consume = _SinkConsume(sink)
        if mode == "container":
            receiver = ContainerReceiver(consume=consume)
            driver.connect(receiver.on_chunk)
            ContainerStreamer(driver, self.chunk_size).send_container(obj)
            driver.close()
            return receiver.result if consume is None else None
        # regular one-shot
        receiver = BlobReceiver()
        driver.connect(receiver.on_chunk)
        ObjectStreamer(driver, self.chunk_size).send_container(obj)
        driver.close()
        return receiver.result

    def _retrieve_pipelined(self, sd: Mapping[str, Any], driver: Driver,
                            mode: str, pipeline: Any,
                            consume: Optional[Callable[[str, Any], None]],
                            sink: Optional[Any]) -> Any:
        # imported here, not at module level: streamers/receivers stay
        # codec-agnostic; only the pull-mode convenience surface knows
        # how to drive a pipeline end to end
        from repro_torch.core.messages import Message, MessageKind

        if consume is not None:
            sink = _ConsumeSink(consume)
        msg = Message(MessageKind.TASK_DATA, dict(sd))
        enc, ctx = pipeline.begin_encode(msg)
        decoder = pipeline.decoder(sink=sink)
        if mode == "container":
            receiver: Any = ContainerReceiver(consume=decoder.on_item,
                                              decode_item=decoder.decode_item)
            driver.connect(receiver.on_chunk)
            ContainerStreamer(driver, self.chunk_size).send_items(
                pipeline.iter_encode_views(enc, ctx), pipeline.n_items(enc)
            )
        else:
            receiver = BlobReceiver(decode_container=decoder.decode_blob)
            driver.connect(receiver.on_chunk)
            ObjectStreamer(driver, self.chunk_size).send_blob(
                pipeline.encode_blob(enc, ctx)
            )
        driver.close()
        out = decoder.finish(msg.kind, pipeline.unsent_headers(enc))
        return out.payload if sink is None else None


class _SinkConsume:
    """Adapts a streaming sink onto the plain receiver ``consume``
    callback (pipeline-less pull path): opens the contribution on the
    first item with weight 1."""

    def __init__(self, sink: Any) -> None:
        self._sink = sink
        self._weight: Optional[float] = None

    def __call__(self, name: str, value: Any) -> None:
        if self._weight is None:
            self._weight = float(self._sink.begin({}))
        self._sink.accept_item(name, value, self._weight)
