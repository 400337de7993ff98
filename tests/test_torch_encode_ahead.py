"""Port parity, encode-ahead and pull mode of ``core/streaming.py``:
``iter_encode_ahead``, ``AdaptiveEncodeAhead``, ``ContainerStreamer(...,
prefetch=)`` and ``ObjectRetriever``, against ``repro.core.streaming``.

* Encode-ahead changes when items are encoded, never what: the same
  items in the same order, the source driven strictly in order, a
  bounded lookahead, a source exception re-raised at the consumer, an
  abandoned iterator that stops its worker, queued items metered as live
  bytes, depth 0 the identity. The wire bytes of two rounds through the
  blockwise8-crc32, nf4-zlib-crc32 and the stateful nf4-delta-crc32
  stacks are bitwise the same at depths 0, 2 and adaptive, and bitwise
  the reference's.
* Pull mode: container, regular and file retrievals give back what was
  registered, with the reference's frames; a pipelined retrieval's
  MemoryMeter peak is one encoded item, as the reference's is (equal
  peaks); a retrieval folded into a streaming aggregator equals the
  reference's fold bitwise.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.fl.aggregator import FedAvgAggregator as RefFedAvg  # noqa: E402
from repro.utils.mem import MemoryMeter as RefMeter  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.fl.aggregator import FedAvgAggregator  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.utils.mem import MemoryMeter  # noqa: E402


def _views(payload: bytes) -> list:
    return [memoryview(payload)]


def _no_worker() -> bool:
    return not [t for t in threading.enumerate()
                if t.name == "wire-encode-ahead" and t.is_alive()]


def test_encode_ahead_preserves_items_and_order():
    items = [(f"t{i}", _views(bytes([i]) * 8)) for i in range(16)]
    for depth in (1, 2, 4, 32):
        got = list(sm.iter_encode_ahead(iter(items), depth))
        assert [n for n, _ in got] == [n for n, _ in items]
        assert [ser.join_views(v) for _, v in got] == [ser.join_views(v) for _, v in items]


def test_encode_ahead_drives_source_strictly_in_order():
    produced = []

    def source():
        for i in range(12):
            produced.append(i)
            yield f"t{i}", _views(b"x" * 4)

    consumed = []
    for name, _ in sm.iter_encode_ahead(source(), depth=3):
        assert produced == sorted(produced)
        consumed.append(name)
    assert consumed == [f"t{i}" for i in range(12)] and produced == list(range(12))


def test_encode_ahead_lookahead_is_bounded():
    produced = threading.Semaphore(0)
    n_produced = [0]

    def source():
        for i in range(64):
            n_produced[0] += 1
            produced.release()
            yield f"t{i}", _views(b"y" * 4)

    depth = 2
    it = sm.iter_encode_ahead(source(), depth)
    next(it)
    for _ in range(depth):
        assert produced.acquire(timeout=5.0)
    time.sleep(0.2)                      # time for an unbounded worker to run away
    assert n_produced[0] <= depth + 2
    it.close()


def test_encode_ahead_reraises_source_exception():
    def source():
        yield "ok", _views(b"z" * 4)
        raise RuntimeError("encode stage blew up")

    it = sm.iter_encode_ahead(source(), depth=2)
    assert next(it)[0] == "ok"
    with pytest.raises(RuntimeError, match="encode stage blew up"):
        list(it)


def test_encode_ahead_abandon_stops_worker_and_frees_queue():
    meter = MemoryMeter()
    with meter.activate():
        it = sm.iter_encode_ahead(((f"t{i}", _views(b"q" * 1024)) for i in range(1000)),
                                  depth=4)
        next(it)
        it.close()
    assert meter.live == 0 and meter.peak >= 1024
    assert _no_worker()


def test_encode_ahead_meters_queued_items_as_live_bytes():
    item = 1 << 16
    for mod, meter in ((sm, MemoryMeter()), (ref_sm, RefMeter())):
        with meter.activate():
            for _ in mod.iter_encode_ahead(
                    ((f"t{i}", _views(b"m" * item)) for i in range(8)), depth=3):
                pass
        assert meter.live == 0
        assert item <= meter.peak <= 5 * item


def test_depth_zero_is_the_identity():
    items = [("a", _views(b"1")), ("b", _views(b"2"))]
    assert list(sm.iter_encode_ahead(iter(items), 0)) == items
    assert _no_worker()


def test_adaptive_encode_ahead_grows_only_under_observed_stalls():
    a = sm.AdaptiveEncodeAhead(depth=2, max_depth=5, grow_threshold=0.10)
    a.observe(0.05, 1.0)
    assert a.depth == 2 and a.grown == 0
    for _ in range(10):
        a.observe(0.5, 1.0)
    assert a.depth == 5 and a.grown == 3
    a.observe(1.0, 0.0)
    assert a.depth == 5
    assert sm.AdaptiveEncodeAhead().depth == sm.DEFAULT_ENCODE_AHEAD == \
        ref_sm.DEFAULT_ENCODE_AHEAD
    assert sm.MAX_ENCODE_AHEAD == ref_sm.MAX_ENCODE_AHEAD
    reg = MetricsRegistry()
    with obs_metrics.activate(reg):
        sm.AdaptiveEncodeAhead(depth=3).observe(1.0, 1.0)
    assert reg.gauge("wire.encode_ahead_depth").as_value() == 4


# ---------------------------------------------------------------------------
# wire bytes: lookahead reorders work, never bytes
# ---------------------------------------------------------------------------

def _sd(round_no: int = 0):
    rng = np.random.default_rng(7 + round_no)
    return {"embed.w": rng.standard_normal((64, 96)).astype(np.float32),
            "layers.0.attn.wq": rng.standard_normal((96, 96)).astype(np.float32),
            "layers.0.norm": rng.standard_normal((96,)).astype(np.float32)}


def _container_bytes(mod, pipeline, msg_cls, kind, prefetch, rounds: int = 2) -> bytes:
    sent = bytearray()

    class _Tap(mod.LoopbackDriver):
        def send(self, chunk):
            for seg in chunk.segments:
                sent.extend(seg)
            super().send(chunk)

    driver = _Tap()
    decoder = pipeline.decoder()
    recv = mod.ContainerReceiver(consume=lambda n, v: None, decode_item=decoder.decode_item)
    driver.connect(recv.on_chunk)
    for rnd in range(rounds):
        msg = msg_cls(kind, _sd(rnd), {"round": rnd, "num_samples": 5})
        msg, ctx = pipeline.begin_encode(msg)
        mod.ContainerStreamer(driver, 4096, prefetch=prefetch).send_items(
            pipeline.iter_encode_views(msg, ctx), pipeline.n_items(msg))
    return bytes(sent)


@pytest.mark.parametrize("stack", [
    ["quantize:blockwise8", "crc32"],
    ["quantize:nf4", "zlib", "crc32"],
    ["quantize:nf4", "delta", "crc32"],          # stateful across rounds
], ids=["blockwise8-crc32", "nf4-zlib-crc32", "nf4-delta-crc32"])
def test_wire_bytes_bitwise_at_every_depth_and_the_reference(stack):
    want = _container_bytes(ref_sm, ref_pl.build_pipeline(list(stack)), RefMessage,
                            RefKind.TASK_RESULT, prefetch=0)
    # threshold 0 grows the adaptive depth after every transfer, so the
    # two rounds of one capture run at different depths
    adaptive = sm.AdaptiveEncodeAhead(depth=1, grow_threshold=0.0)
    for prefetch in (0, 2, adaptive):
        got = _container_bytes(sm, pl.build_pipeline(list(stack), device="cpu"), Message,
                               MessageKind.TASK_RESULT, prefetch=prefetch)
        assert got == want, prefetch
    assert adaptive.grown >= 1


def test_encode_wait_telemetry_lands_in_active_registry():
    reg = MetricsRegistry()
    with obs_metrics.activate(reg):
        _container_bytes(sm, pl.build_pipeline(["quantize:nf4", "crc32"], device="cpu"),
                         Message, MessageKind.TASK_RESULT, prefetch=2, rounds=1)
    assert reg.histogram("wire.encode_wait_us").as_value()["count"] > 0
    assert reg.gauge("wire.encode_ahead_depth").as_value() == 2


# ---------------------------------------------------------------------------
# ObjectRetriever (pull mode)
# ---------------------------------------------------------------------------

class _Frames:
    """Wraps a loopback driver and keeps each frame without its stream id."""

    def __init__(self, mod):
        self.inner = mod.LoopbackDriver()
        self.frames = []

    def connect(self, on_chunk):
        self.inner.connect(on_chunk)

    def send(self, chunk):
        self.frames.append(chunk.encode()[16:])
        self.inner.send(chunk)

    def close(self):
        self.inner.close()


def _state_dict():
    rng = np.random.default_rng(3)
    return {"embed": rng.standard_normal((100, 64)).astype(np.float32),
            "w": rng.standard_normal((64, 64)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32)}


def test_retriever_modes_and_frames_match_the_reference(tmp_path):
    sd = _state_dict()
    src = tmp_path / "f.bin"
    src.write_bytes(os.urandom(5000))
    frames = {}
    for tag, mod in (("port", sm), ("ref", ref_sm)):
        retr = mod.ObjectRetriever(chunk_size=512)
        retr.register_container("weights", sd)
        retr.register_file("ckpt", str(src))
        for mode in ("container", "regular"):
            drv = _Frames(mod)
            out = retr.retrieve("weights", driver=drv, mode=mode)
            for k, v in sd.items():
                assert np.asarray(out[k]).tobytes() == v.tobytes()
            frames[tag, mode] = drv.frames
        drv = _Frames(mod)
        out = retr.retrieve("ckpt", driver=drv, out_path=str(tmp_path / f"{tag}.bin"))
        assert open(out, "rb").read() == src.read_bytes()
        frames[tag, "file"] = drv.frames
    for mode in ("container", "regular", "file"):
        assert frames["port", mode] == frames["ref", mode], mode


def test_retriever_pipeline_frames_and_peak_match_the_reference():
    """A pipelined pull is the push wire: the same per-item envelopes on
    the wire, and a MemoryMeter peak of about one encoded item — the
    reference's peak, byte for byte."""
    sd = {f"l{i}": np.random.default_rng(i).standard_normal((128, 128)).astype(np.float32)
          for i in range(16)}
    total = sum(v.nbytes for v in sd.values())
    stack = ["quantize:nf4", "crc32"]
    got, peaks, frames = {}, {}, {}
    for tag, mod, meter, pipe in (
            ("port", sm, MemoryMeter(), pl.build_pipeline(stack, device="cpu")),
            ("ref", ref_sm, RefMeter(), ref_pl.build_pipeline(stack))):
        retr = mod.ObjectRetriever(chunk_size=2048)
        retr.register_container("weights", sd)
        drv = _Frames(mod)
        seen = got.setdefault(tag, {})
        with meter.activate():
            assert retr.retrieve("weights", driver=drv, pipeline=pipe,
                                 consume=lambda n, v, _s=seen: _s.update({n: v})) is None
        peaks[tag], frames[tag] = meter.peak, drv.frames
    assert len(got["port"]) == len(sd)
    assert peaks["port"] == peaks["ref"] < total / 4
    assert frames["port"] == frames["ref"]
    for k in sd:
        assert np.asarray(got["port"][k]).tobytes() == np.asarray(got["ref"][k]).tobytes()


def test_retriever_streams_into_an_aggregation_sink_like_the_reference():
    rng = np.random.default_rng(5)
    sd = {"a": rng.standard_normal(300).astype(np.float32),
          "b": rng.standard_normal((8, 40)).astype(np.float32)}
    stack = ["quantize:blockwise8", "crc32"]
    port_agg, ref_agg = FedAvgAggregator(device="cpu"), RefFedAvg()
    for mod, agg, pipe in ((sm, port_agg, pl.build_pipeline(stack, device="cpu")),
                           (ref_sm, ref_agg, ref_pl.build_pipeline(stack))):
        retr = mod.ObjectRetriever()
        retr.register_container("w", sd)
        for _ in range(2):
            assert retr.retrieve("w", pipeline=pipe, sink=agg) is None
    port_out, ref_out = port_agg.finish(), ref_agg.finish()
    assert set(port_out) == set(ref_out) == set(sd)
    for k in sd:
        assert port_out[k].numpy().tobytes() == np.asarray(ref_out[k]).tobytes()
    # pipeline-less pull into a sink, and the refusals
    retr = sm.ObjectRetriever()
    retr.register_container("w", sd)
    agg = FedAvgAggregator(device="cpu")
    retr.retrieve("w", sink=agg)
    for k, v in agg.finish().items():
        assert v.numpy().tobytes() == sd[k].tobytes()
    with pytest.raises(ValueError, match="not both"):
        retr.retrieve("w", pipeline=pl.build_pipeline([], device="cpu"),
                      consume=lambda n, v: None, sink=FedAvgAggregator(device="cpu"))
    with pytest.raises(ValueError, match="container"):
        retr.retrieve("w", mode="regular", sink=FedAvgAggregator(device="cpu"))
