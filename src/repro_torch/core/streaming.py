"""SFM-style streaming layer (paper §I Fig. 1 and §III).

Mirror of ``src/repro/core/streaming.py``, the subset the simulator and
the paper's Table III run:

* **Frames** — :class:`Chunk`: fixed-size (default 1 MiB) framed slices of
  a logical stream, carrying (stream_id, seq, eof) headers.
* **Drivers** — transport plugins, looked up by name through
  :func:`register_driver`/:func:`make_driver`: :class:`LoopbackDriver`
  (in-process delivery) and :class:`FileSpoolDriver` (frames spooled to
  disk, replayed on ``flush()``). The TCP driver waits (ROADMAP A5).
* **Streamers** — the three transmission modes with distinct peak-memory
  envelopes (paper Fig. 3): :class:`ObjectStreamer` (*regular*: one
  pre-encoded blob, peak ~ the model, received by :class:`BlobReceiver`),
  :class:`ContainerStreamer` (one encoded dict item at a time, peak ~
  the largest item, reassembled by :class:`ContainerReceiver` into one
  preallocated buffer per item) and :class:`FileStreamer` (a file chunk
  by chunk, peak ~ one chunk, written out by :class:`FileReceiver`). The
  pull-mode retriever and encode-ahead wait for a later slice.

The layer is zero-copy: items arrive as ordered buffer views, chunkers
slice the views, and loopback delivery hands the segments to the
receiver as they are. Every buffer the layer holds live registers with
the active :class:`~repro_torch.utils.mem.MemoryMeter`.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import uuid
from collections.abc import Callable, Iterable, Iterator, Mapping
from typing import Any, Optional

from repro_torch.core import serialization as ser
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
NOT_PORTED_DRIVERS = ("tcp",)


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
    """Paper §III: transmit **one parameter-dict item at a time**."""

    def __init__(self, driver: Driver, chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
        self.driver = driver
        self.chunk_size = chunk_size

    def send_items(self, items: Iterable[tuple[str, ser.ViewsLike]], total: int) -> bytes:
        """Stream ``total`` pre-encoded items, framing item boundaries.

        The item source is any (name, item) iterator — the plain
        serialization codec or a wire pipeline's envelope encoder — and
        is consumed lazily, so peak live bytes stays ~one encoded item.
        Each item may be contiguous bytes or a scatter-gather view list
        (:data:`repro_torch.core.serialization.Views`); views flow
        through to the driver unjoined.
        """
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
