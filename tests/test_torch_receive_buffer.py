"""The streaming receiver's reassembly buffer, on the CPU.

A multi-chunk item is assembled in one uninitialised ``torch.empty``
byte tensor, page-locked only when the decoder lands its tensors on a
CUDA device (the card's half of these checks is
``tests/test_torch_receive_buffer_cuda.py``). Held here against the
reference's receiver, which assembles each item in a fresh zero-filled
``bytearray`` as the port did before: on one recorded chunk stream both
hand their decoders the item's wire bytes, bitwise, at chunk sizes that
cut the u32 header length, the JSON headers and the payload at every
byte, and the MemoryMeter counts the same copies, allocations and peak.
Repaired streams (drops, duplicates, reordering) decode to the clean
stream's values, a decoded view that outlives its item keeps its bytes,
an item short of its declared length never reaches a decoder, and no
receiver on the CPU pins.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import streaming as ref_sm  # noqa: E402
from repro.utils.mem import MemoryMeter as RefMeter  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import resilience as rs  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.utils.mem import MemoryMeter  # noqa: E402

STACKS = {"plain": None, "blockwise8": ["quantize:blockwise8"],
          "blockwise8-crc32": ["quantize:blockwise8", "crc32"]}
WIDE = (61, 1000, 4097, 1 << 14)   # odd sizes and 1/64 MiB


def _sd(seed=0, rows=48):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((rows, 40)).astype(np.float32),
            "b": rng.standard_normal((40,)).astype(np.float32),
            "step": np.asarray(7, np.int32)}


def _big_sd(seed=0):
    """Items of a few 1/64 MiB chunks each, and one under a chunk."""
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((96, 512)).astype(np.float32),
            "mlp": rng.standard_normal((64, 384)).astype(np.float32),
            "norm": rng.standard_normal((64,)).astype(np.float32)}


def _items(stack, sd):
    """(name, wire views) of each item of one transfer of ``sd``."""
    if STACKS[stack] is None:
        return list(ser.iter_serialized_items(sd))
    pipe = pl.build_pipeline(STACKS[stack], device="cpu")
    msg, ctx = pipe.begin_encode(Message(MessageKind.TASK_RESULT, dict(sd),
                                         {"num_samples": 3}))
    return list(pipe.iter_encode_views(msg, ctx))


class _Record:
    """A driver that keeps the chunks it is given."""

    def __init__(self):
        self.chunks = []

    def connect(self, on_chunk):
        pass

    def send(self, chunk):
        self.chunks.append(chunk)


def _chunks(items, chunk_size):
    rec = _Record()
    sm.ContainerStreamer(rec, chunk_size).send_items(iter(items), len(items))
    return rec.chunks


def _receive(pkg, meter, chunks):
    """The bytes each item's decoder is handed by ``pkg``'s receiver."""
    seen = []

    def decode(buf):
        raw = b"".join(bytes(s) for s in buf) if isinstance(buf, list) else bytes(buf)
        seen.append(raw)
        return f"item{len(seen)}", raw, len(raw)

    recv = pkg.ContainerReceiver(consume=lambda n, v: None, decode_item=decode)
    with meter.activate():
        for c in chunks:
            recv.on_chunk(c)
    assert recv.done
    return seen


def _header_span(items):
    """Bytes from an item's start to the end of its last JSON header
    (the envelope's, then the inner item's), over every item."""
    span = 0
    for _name, views in items:
        raw = ser.join_views(views)
        outer = 4 + int.from_bytes(raw[:4], "little")
        inner = int.from_bytes(raw[outer:outer + 4], "little") if len(raw) > outer + 4 else 0
        span = max(span, outer + 4 + inner if inner < len(raw) else outer)
    return span


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_every_cut_reassembles_the_wire_bytes_like_the_reference(stack):
    items = _items(stack, _sd())
    want = [ser.join_views(v) for _n, v in items]
    sizes = list(range(1, min(_header_span(items) + 6, max(map(len, want)))))
    assert len(sizes) > 40
    for chunk in sizes + list(WIDE):
        chunks = _chunks(items, chunk)
        port = _receive(sm, MemoryMeter(), chunks)
        ref = _receive(ref_sm, RefMeter(), chunks)
        assert port == ref == want, chunk


@pytest.mark.parametrize("chunk", (1, 7, 61, 1000, 1 << 14))
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_meter_counts_like_the_reference_receiver(stack, chunk):
    chunks = _chunks(_items(stack, _big_sd()), chunk)
    port, ref = MemoryMeter(), RefMeter()
    assert _receive(sm, port, chunks) == _receive(ref_sm, ref, chunks)
    got, want = port.as_dict(), ref.as_dict()
    for key in ("copied", "total_allocated", "peak"):
        assert got[key] == want[key], key
    assert got == want
    assert port.live == 0


def _decode_transfer(stack, sd, driver=None, chunk=1 << 14, decode_values=True):
    """One pipelined transfer through a container receiver; returns the
    decoded payload."""
    pipe = pl.build_pipeline(STACKS[stack], device="cpu", decode_values=decode_values)
    msg, ctx = pipe.begin_encode(Message(MessageKind.TASK_RESULT, dict(sd),
                                         {"num_samples": 3}))
    dec = pipe.decoder()
    recv = sm.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item,
                                device=dec.ctx.device)
    views = pipe.iter_encode_views(msg, ctx)
    if driver is None:
        driver = sm.LoopbackDriver()
        driver.connect(recv.on_chunk)
        sm.ContainerStreamer(driver, chunk).send_items(views, pipe.n_items(msg))
    else:
        assert rs.ReliableTransfer(driver, chunk).send_items(views, pipe.n_items(msg), recv)
    return dec.finish(MessageKind.TASK_RESULT).payload


def _as_bytes(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous().numpy().tobytes()
    if hasattr(value, "payload"):
        return _as_bytes(value.payload) + _as_bytes(value.absmax)
    return np.asarray(value).tobytes()


@pytest.mark.parametrize("drop, dup, reorder",
                         [(0.3, 0.0, 0), (0.0, 0.4, 0), (0.0, 0.0, 5), (0.25, 0.25, 4)])
@pytest.mark.parametrize("stack", ["blockwise8", "blockwise8-crc32"])
def test_repaired_streams_decode_like_the_clean_stream(stack, drop, dup, reorder):
    sd = _big_sd(1)
    clean = _decode_transfer(stack, sd, chunk=1001)
    lossy = rs.LossyDriver(sm.LoopbackDriver(), drop_prob=drop, dup_prob=dup,
                           reorder_window=reorder, seed=5)
    got = _decode_transfer(stack, sd, driver=lossy, chunk=1001)
    assert list(got) == list(clean) == list(sd)
    for name in sd:
        assert _as_bytes(got[name]) == _as_bytes(clean[name]), name


def test_decoded_view_outlives_its_item():
    """Collect mode without decoding values keeps each item's codes as
    read-only views into its reassembly buffer: they hold their bytes
    while later items and a second transfer are received."""
    first = _decode_transfer("blockwise8-crc32", _big_sd(2), decode_values=False)
    kept = {name: _as_bytes(v) for name, v in first.items()}
    codes = first["embed"].payload
    assert isinstance(codes, np.ndarray) and not codes.flags.writeable
    second = _decode_transfer("blockwise8-crc32", _big_sd(3), decode_values=False)
    third = _decode_transfer("blockwise8-crc32", _big_sd(2), decode_values=False)
    for name, value in first.items():
        assert _as_bytes(value) == kept[name] == _as_bytes(third[name]), name
        assert _as_bytes(second[name]) != kept[name], name


def test_item_short_of_its_declared_length_never_reaches_the_decoder():
    items = _items("blockwise8-crc32", _big_sd())
    chunks = _chunks(items[1:2], 1000)
    assert len(chunks) > 3
    cut = chunks[:-2] + [sm.Chunk(chunks[-2].stream_id, chunks[-2].seq,
                                  chunks[-2].payload, sm.FLAG_ITEM_END | sm.FLAG_EOF)]
    decoded = []
    recv = sm.ContainerReceiver(consume=lambda n, v: None,
                                decode_item=lambda buf: decoded.append(buf))
    with pytest.raises(ValueError, match="declared"):
        for c in cut:
            recv.on_chunk(c)
    assert decoded == []


def _reassemble_spans(run):
    tracer = Tracer()
    with obs_trace.activate(tracer):
        run()
    return [ev["args"] for ev in tracer.chrome_trace()["traceEvents"]
            if ev.get("name") == "wire.reassemble"]


@pytest.mark.parametrize("case", ["cpu-decoder", "no-decoder", "retriever",
                                  "retriever-pipelined"])
def test_no_receiver_pins_on_the_cpu(case):
    sd = _big_sd(4)
    if case == "cpu-decoder":
        spans = _reassemble_spans(lambda: _decode_transfer("blockwise8-crc32", sd))
    elif case == "no-decoder":
        def run():
            recv = sm.ContainerReceiver()
            driver = sm.LoopbackDriver()
            driver.connect(recv.on_chunk)
            sm.ContainerStreamer(driver, 1 << 14).send_container(sd)
            for name, arr in sd.items():
                assert np.asarray(recv.result[name]).tobytes() == arr.tobytes()
        spans = _reassemble_spans(run)
    else:
        pipe = (pl.build_pipeline(STACKS["blockwise8-crc32"], device="cpu")
                if case == "retriever-pipelined" else None)
        holder = sm.ObjectRetriever(chunk_size=1 << 14, pipeline=pipe)
        holder.register_container("m", sd)
        spans = _reassemble_spans(lambda: holder.retrieve("m", mode="container"))
    assert len(spans) >= 2
    assert all(sp["pinned"] is False for sp in spans)
    assert all(sp["alloc_s"] >= 0 for sp in spans)


def test_only_a_cuda_decoder_asks_for_page_locked_buffers():
    """The receiver's choice follows the device it is given: the CUDA
    type alone pins, whatever the index."""
    assert not sm.ContainerReceiver()._asm._pin
    assert not sm.ContainerReceiver(device="cpu")._asm._pin
    assert not sm.ContainerReceiver(device=torch.device("cpu"))._asm._pin
    assert sm.ContainerReceiver(device="cuda")._asm._pin
    assert sm.ContainerReceiver(device=torch.device("cuda", 0))._asm._pin
