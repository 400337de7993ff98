"""Framed binary serialization for FL messages (FOBS analogue).

Mirror of ``src/repro/core/serialization.py``: byte-for-byte the same
wire format. Device tensors cross into numpy here (one device-to-host
copy per unquantized tensor item); header dtype strings are numpy names
(``"float32"``, ``"int8"``), as the reference writes them, and
``"bfloat16"`` (the name the reference's ``ml_dtypes`` gives it) for a
bf16 tensor: numpy has no bfloat16, so the port carries those 2-byte
words as ``int16`` and views them as a torch ``bfloat16`` tensor on
decode. The ``lowrank`` item kind carries a
:class:`~repro_torch.peft.lowrank.LowRankDelta` factor pair.

NVFlare serializes messages with FOBS; we implement a small deterministic
framed format so that message sizes are byte-exact and auditable:

    item  := header_len (u32 LE) | header (utf-8 JSON) | payload bytes
    blob  := n_items (u32 LE) | item*

The header carries name/shape/dtype plus quantization metadata for
:class:`~repro_torch.core.quantization.QuantizedTensor` items. Payload bytes are
the raw array buffer (C-order). No pickling — wire format is portable and
safe to parse from untrusted peers.

Zero-copy discipline: the hot path works in **buffer views**, not joined
byte strings. :func:`serialize_item_views` emits an ordered list of
bytes-like segments (iovec-style) whose concatenation *is* the item's
wire bytes — array payloads stay ``memoryview``s over the tensors'
own buffers, so encoding an item costs one small header allocation and
zero payload copies. :func:`deserialize_item` accepts any buffer
(``bytes``/``bytearray``/``memoryview``) and returns ``frombuffer``
array views into it, so decoding copies nothing either. The joined-bytes
functions (:func:`serialize_item`, :func:`serialize_container`) remain
as the convenience/compat surface and are defined as "join the views".

This module is the *inner* codec only. When a
:class:`~repro_torch.core.pipeline.WirePipeline` carries per-item transforms
(quantize, compress, checksum), each item here becomes the body of a
self-describing pipeline **envelope** whose header records the stage
stack and per-stage metadata — see ``repro_torch.core.pipeline`` for that
outer framing.
"""
from __future__ import annotations

import json
import struct
from collections.abc import Iterator, Mapping, Sequence
from typing import Any, Union

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedTensor
from repro_torch.core.sparse import SparseTensor
from repro_torch.peft.lowrank import LowRankDelta
from repro_torch.utils import mem
from repro_torch.utils.trees import as_numpy, as_tensor, numpy_dtype

_U32 = struct.Struct("<I")

#: one wire item as an ordered list of buffer segments (iovec); the
#: item's wire bytes are the concatenation of the segments
Views = list[Union[bytes, memoryview]]
#: what streamers accept per item: pre-joined bytes or a view list
ViewsLike = Union[bytes, bytearray, memoryview, Sequence[Union[bytes, memoryview]]]

#: the wire's name for bfloat16 (the reference's ml_dtypes name)
BF16 = "bfloat16"


def wire_dtype(x: Any) -> str:
    """The header dtype string of an array or tensor: its numpy name, or
    ``"bfloat16"`` for a bf16 tensor."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return BF16
    return str(numpy_dtype(x.dtype))


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype whose words carry a header dtype string's values."""
    return np.dtype(np.int16) if name == BF16 else np.dtype(name)


def _typed(arr: np.ndarray, name: str) -> Any:
    """A decoded buffer as its header dtype: numpy, or for ``"bfloat16"``
    a CPU bf16 tensor over the same words (no copy)."""
    return as_tensor(arr, "cpu").view(torch.bfloat16) if name == BF16 else arr


def _as_view(a: Any) -> Union[bytes, memoryview]:
    """Flat byte view over an array's buffer — zero-copy when the array
    is already C-contiguous (``ascontiguousarray`` is then a no-op);
    falls back to ``tobytes`` for dtypes without buffer-protocol support
    (that copy is recorded with the meter). The view is exported
    **read-only**: on a zero-copy hop (loopback) it may reach the
    receiving decoder directly, and nothing downstream may scribble on
    the sender's tensors through it. A bf16 tensor exports its 2-byte
    words."""
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    src = as_numpy(a)
    arr = np.ascontiguousarray(src)
    if not np.shares_memory(arr, src):
        mem.record_copy(arr.nbytes)  # non-contiguous input: real memcpy
    try:
        return memoryview(arr).toreadonly().cast("B")
    except (TypeError, ValueError, NotImplementedError):
        out = arr.tobytes()
        mem.record_copy(len(out))
        return out


def views_nbytes(views: ViewsLike) -> int:
    """Total wire length of one item, joined or scattered."""
    if isinstance(views, (bytes, bytearray, memoryview)):
        return len(views)
    return sum(v.nbytes if isinstance(v, memoryview) else len(v) for v in views)


def join_views(views: ViewsLike) -> bytes:
    """Materialize one item's wire bytes (records the copy). This is the
    only place view-mode items become contiguous — drivers call it at
    the real transport boundary, nowhere earlier."""
    if isinstance(views, bytes):
        return views
    if isinstance(views, (bytearray, memoryview)):
        mem.record_copy(len(views))
        return bytes(views)
    out = b"".join(views)
    mem.record_copy(len(out))
    return out


def iter_view_segments(views: ViewsLike) -> Iterator[memoryview]:
    """Normalize an item to flat memoryview segments (zero-copy)."""
    if isinstance(views, (bytes, bytearray, memoryview)):
        views = (views,)
    for v in views:
        mv = v if isinstance(v, memoryview) else memoryview(v)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        if mv.nbytes:
            yield mv


class SegmentCursor:
    """Zero-copy reader over an ordered list of buffer segments.

    Receive-side counterpart of :data:`Views`: a single-chunk item
    arrives from a scatter-gather hop as the sender's unjoined segments
    (header bytes, then payload views), and the cursor reads fields
    straight out of them — a read that falls inside one segment returns
    a read-only ``memoryview`` slice (zero-copy), and only a read that
    crosses a segment boundary joins those bytes (recording the copy).
    Over the loopback driver the segments *are* the encode-side views,
    so header-from-segment-0 / ``frombuffer``-segment-1 decoding makes
    small-item receive fully zero-copy.
    """

    __slots__ = ("_segs", "_i", "_off", "consumed")

    def __init__(self, segments: Sequence[Any]) -> None:
        self._segs = [mv.toreadonly() for mv in iter_view_segments(list(segments))]
        self._i = 0
        self._off = 0
        self.consumed = 0

    @property
    def remaining(self) -> int:
        if self._i >= len(self._segs):
            return 0
        return (self._segs[self._i].nbytes - self._off) + sum(
            s.nbytes for s in self._segs[self._i + 1:]
        )

    def read_views(self, n: int) -> Views:
        """The next ``n`` bytes as zero-copy segment slices."""
        out: Views = []
        need = n
        while need > 0:
            if self._i >= len(self._segs):
                raise ValueError(
                    f"segmented item truncated: wanted {n} more bytes, "
                    f"had {n - need}"
                )
            seg = self._segs[self._i]
            take = min(need, seg.nbytes - self._off)
            out.append(
                seg if take == seg.nbytes and self._off == 0
                else seg[self._off:self._off + take]
            )
            self._off += take
            need -= take
            if self._off == seg.nbytes:
                self._i += 1
                self._off = 0
        self.consumed += n
        return out

    def read(self, n: int) -> Union[bytes, memoryview]:
        """The next ``n`` bytes, contiguous: a zero-copy view when they
        lie within one segment, a joined copy (recorded) otherwise."""
        views = self.read_views(n)
        if len(views) == 1:
            return views[0]
        out = b"".join(views)
        mem.record_copy(len(out))
        return out


def serialize_item_views(name: str, value: Any) -> Views:
    """One state-dict item -> ordered wire segments (header, then the
    payload buffers as zero-copy views). ``b"".join`` of the result is
    byte-identical to :func:`serialize_item`."""
    if isinstance(value, SparseTensor):
        idx = _as_view(value.indices)
        vals = _as_view(value.values)
        header = {
            "kind": "sparse",
            "name": name,
            "k": int(value.values.size),
            "idx_dtype": str(np.asarray(value.indices).dtype),
            "val_dtype": str(np.asarray(value.values).dtype),
            "orig_shape": list(value.orig_shape),
            "orig_dtype": str(np.dtype(value.orig_dtype)),
        }
        hbytes = json.dumps(header, sort_keys=True).encode()
        return [_U32.pack(len(hbytes)) + hbytes, idx, vals]
    if isinstance(value, LowRankDelta):
        a = _as_view(value.a)
        b = _as_view(value.b)
        header = {
            "kind": "lowrank",
            "name": name,
            "a_shape": list(value.a.shape),
            "a_dtype": wire_dtype(value.a),
            "b_shape": list(value.b.shape),
            "b_dtype": wire_dtype(value.b),
            "alpha": float(value.alpha),
            "rank": int(value.rank),
            "orig_shape": list(value.orig_shape),
            "orig_dtype": str(np.dtype(value.orig_dtype)),
        }
        hbytes = json.dumps(header, sort_keys=True).encode()
        return [_U32.pack(len(hbytes)) + hbytes, a, b]
    if isinstance(value, QuantizedTensor):
        payload = _as_view(value.payload)
        absmax = _as_view(value.absmax) if value.absmax is not None else b""
        header = {
            "kind": "qtensor",
            "name": name,
            "fmt": value.fmt,
            "payload_shape": list(value.payload.shape),
            "payload_dtype": wire_dtype(value.payload),
            "absmax_len": views_nbytes([absmax]),
            "absmax_shape": list(value.absmax.shape) if value.absmax is not None else [],
            "orig_shape": list(value.orig_shape),
            "orig_dtype": str(np.dtype(value.orig_dtype)),
        }
        hbytes = json.dumps(header, sort_keys=True).encode()
        views: Views = [_U32.pack(len(hbytes)) + hbytes, payload]
        if views_nbytes([absmax]):
            views.append(absmax)
        return views
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
    header = {
        "kind": "array",
        "name": name,
        "shape": list(value.shape),
        "dtype": wire_dtype(value),
    }
    hbytes = json.dumps(header, sort_keys=True).encode()
    return [_U32.pack(len(hbytes)) + hbytes, _as_view(value)]


def serialize_item(name: str, value: Any) -> bytes:
    """Serialize one state-dict item (array/tensor, QuantizedTensor,
    SparseTensor or LowRankDelta) to contiguous bytes — the views,
    joined."""
    return join_views(serialize_item_views(name, value))


def declared_item_nbytes(buf: Union[bytes, bytearray, memoryview]) -> int | None:
    """Total wire length of the item at the head of ``buf``, parsed from
    its header alone — what a receiver preallocates its reassembly
    buffer from. Returns None while ``buf`` is still shorter than the
    header, or for unknown header kinds."""
    mv = memoryview(buf)
    if mv.nbytes < 4:
        return None
    (hlen,) = _U32.unpack_from(mv, 0)
    if mv.nbytes < 4 + hlen:
        return None
    try:
        header = json.loads(bytes(mv[4:4 + hlen]))
    except (ValueError, UnicodeDecodeError):
        return None
    kind = header.get("kind")
    try:
        if kind in ("wire", "meta"):
            body = int(header["n"])
        elif kind == "array":
            shape = tuple(header["shape"])
            body = int(np.prod(shape)) * storage_dtype(header["dtype"]).itemsize if shape \
                else storage_dtype(header["dtype"]).itemsize
        elif kind == "qtensor":
            pshape = tuple(header["payload_shape"])
            pdtype = storage_dtype(header["payload_dtype"])
            body = (int(np.prod(pshape)) if pshape else 1) * pdtype.itemsize
            body += int(header["absmax_len"])
        elif kind == "sparse":
            k = int(header["k"])
            body = k * (np.dtype(header["idx_dtype"]).itemsize
                        + np.dtype(header["val_dtype"]).itemsize)
        elif kind == "lowrank":
            body = sum(int(np.prod(header[f"{f}_shape"]))
                       * storage_dtype(header[f"{f}_dtype"]).itemsize for f in "ab")
        else:
            return None
    except (KeyError, TypeError, ValueError):
        return None
    return 4 + hlen + body


def _lowrank(header: Mapping[str, Any], read: Any) -> LowRankDelta:
    """The factor pair of a ``lowrank`` header; ``read(dtype, count)``
    returns the next ``count`` words of ``dtype`` from the item body."""
    factors = []
    for f in "ab":
        shape = tuple(header[f"{f}_shape"])
        dtype = header[f"{f}_dtype"]
        words = read(storage_dtype(dtype), int(np.prod(shape))).reshape(shape)
        factors.append(_typed(words, dtype))
    return LowRankDelta(factors[0], factors[1], float(header["alpha"]),
                        int(header["rank"]), tuple(header["orig_shape"]),
                        np.dtype(header["orig_dtype"]))


def deserialize_item(buf: Union[bytes, bytearray, memoryview, Sequence]) -> tuple[str, Any, int]:
    """Parse one item from the head of ``buf``; returns (name, value,
    consumed). Arrays are ``frombuffer`` views into ``buf`` — no payload
    copy; the caller keeps the buffer alive as long as the values.
    Decoded arrays are **read-only** (exactly like the pre-views wire,
    which decoded from immutable ``bytes``): consumers that need to
    mutate copy first, and a zero-copy loopback hop can never write
    back into the sender's buffers.

    ``buf`` may also be a **list/tuple of segments** (an unjoined
    scatter-gather item, as a zero-copy receiver holds it): the header
    is read from the leading segment and each payload field is a
    ``frombuffer`` view over its own segment, so a single-chunk item
    whose segments mirror :func:`serialize_item_views` decodes with
    zero copies; only fields that straddle a segment boundary join."""
    if isinstance(buf, (list, tuple)):
        return _deserialize_item_segments(SegmentCursor(buf))
    mv = (buf if isinstance(buf, memoryview) else memoryview(buf)).toreadonly()
    (hlen,) = _U32.unpack_from(mv, 0)
    header = json.loads(bytes(mv[4:4 + hlen]))
    off = 4 + hlen
    if header["kind"] == "sparse":
        k = int(header["k"])
        idx_dtype = np.dtype(header["idx_dtype"])
        val_dtype = np.dtype(header["val_dtype"])
        indices = np.frombuffer(mv, idx_dtype, count=k, offset=off)
        off += k * idx_dtype.itemsize
        values = np.frombuffer(mv, val_dtype, count=k, offset=off)
        off += k * val_dtype.itemsize
        sp = SparseTensor(indices, values, tuple(header["orig_shape"]),
                          np.dtype(header["orig_dtype"]))
        return header["name"], sp, off
    if header["kind"] == "lowrank":
        def read(dtype: np.dtype, count: int) -> np.ndarray:
            nonlocal off
            words = np.frombuffer(mv, dtype, count=count, offset=off)
            off += count * dtype.itemsize
            return words

        return header["name"], _lowrank(header, read), off
    if header["kind"] == "qtensor":
        pshape = tuple(header["payload_shape"])
        pdtype = storage_dtype(header["payload_dtype"])
        pbytes = int(np.prod(pshape)) * pdtype.itemsize if pshape else pdtype.itemsize
        payload = _typed(np.frombuffer(mv, pdtype, count=int(np.prod(pshape)),
                                       offset=off).reshape(pshape), header["payload_dtype"])
        off += pbytes
        absmax = None
        if header["absmax_len"]:
            ashape = tuple(header["absmax_shape"])
            absmax = np.frombuffer(
                mv, np.float32, count=int(np.prod(ashape)), offset=off
            ).reshape(ashape)
            off += header["absmax_len"]
        value: Any = QuantizedTensor(
            payload, absmax, header["fmt"], tuple(header["orig_shape"]),
            np.dtype(header["orig_dtype"]),
        )
        return header["name"], value, off
    shape = tuple(header["shape"])
    dtype = storage_dtype(header["dtype"])
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(mv, dtype, count=count, offset=off).reshape(shape)
    return header["name"], _typed(arr, header["dtype"]), off + count * dtype.itemsize


def _deserialize_item_segments(cur: SegmentCursor) -> tuple[str, Any, int]:
    """Segment-aware :func:`deserialize_item` body: header from the
    leading segment, each payload field ``frombuffer``'d out of its own
    segment(s) via the cursor (copying only on boundary straddles)."""
    (hlen,) = _U32.unpack(bytes(cur.read(4)))
    header = json.loads(bytes(cur.read(hlen)))
    if header["kind"] == "sparse":
        k = int(header["k"])
        idx_dtype = np.dtype(header["idx_dtype"])
        val_dtype = np.dtype(header["val_dtype"])
        indices = np.frombuffer(cur.read(k * idx_dtype.itemsize), idx_dtype, count=k)
        values = np.frombuffer(cur.read(k * val_dtype.itemsize), val_dtype, count=k)
        sp = SparseTensor(indices, values, tuple(header["orig_shape"]),
                          np.dtype(header["orig_dtype"]))
        return header["name"], sp, cur.consumed
    if header["kind"] == "lowrank":
        def read(dtype: np.dtype, count: int) -> np.ndarray:
            return np.frombuffer(cur.read(count * dtype.itemsize), dtype, count=count)

        return header["name"], _lowrank(header, read), cur.consumed
    if header["kind"] == "qtensor":
        pshape = tuple(header["payload_shape"])
        pdtype = storage_dtype(header["payload_dtype"])
        pcount = int(np.prod(pshape)) if pshape else 1
        payload = _typed(np.frombuffer(
            cur.read(pcount * pdtype.itemsize), pdtype, count=pcount
        ).reshape(pshape), header["payload_dtype"])
        absmax = None
        if header["absmax_len"]:
            ashape = tuple(header["absmax_shape"])
            absmax = np.frombuffer(
                cur.read(int(header["absmax_len"])), np.float32,
                count=int(np.prod(ashape)),
            ).reshape(ashape)
        value: Any = QuantizedTensor(
            payload, absmax, header["fmt"], tuple(header["orig_shape"]),
            np.dtype(header["orig_dtype"]),
        )
        return header["name"], value, cur.consumed
    shape = tuple(header["shape"])
    dtype = storage_dtype(header["dtype"])
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(
        cur.read(count * dtype.itemsize), dtype, count=count
    ).reshape(shape)
    return header["name"], _typed(arr, header["dtype"]), cur.consumed


def serialize_container(sd: Mapping[str, Any]) -> bytes:
    """Whole-message serialization (the *regular transmission* path —

    materializes the full blob in one join; registers it with the
    MemoryMeter)."""
    parts: Views = [_U32.pack(len(sd))]
    for name, value in sd.items():
        parts.extend(serialize_item_views(name, value))
    blob = b"".join(parts)
    mem.record_copy(len(blob))
    mem.record_alloc(len(blob))
    return blob


def deserialize_container(blob: Union[bytes, bytearray, memoryview]) -> dict[str, Any]:
    mv = blob if isinstance(blob, memoryview) else memoryview(blob)
    (n,) = _U32.unpack_from(mv, 0)
    out: dict[str, Any] = {}
    off = 4
    for _ in range(n):
        name, value, consumed = deserialize_item(mv[off:])
        out[name] = value
        off += consumed
    return out


def iter_serialized_items(sd: Mapping[str, Any]) -> Iterator[tuple[str, Views]]:
    """Container-streaming producer: yields one item's wire segments at a
    time (peak live bytes = largest single item, the paper's §III claim;
    the segments are zero-copy views over the tensors themselves)."""
    for name, value in sd.items():
        views = serialize_item_views(name, value)
        with mem.record_hold(views_nbytes(views)):
            yield name, views
