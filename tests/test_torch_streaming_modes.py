"""Port parity: the paper's three transmission modes (regular / container /
file, §III and Table III) and the spool driver, against the reference's
``core/streaming.py`` on the same seeded dicts, on the CPU.

Tolerance: none. Chunk payloads, flags and counts are compared bitwise
(stream ids are random uuids on both sides and are left out), decoded
dicts bitwise, and the MemoryMeter's accounting (peak, total allocated,
bytes copied) exactly: the meter counts the transmission buffers the
layer allocates, which are a function of the dict and the chunk size
only, so the port must register the same buffers as the reference.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import serialization as ref_ser  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.utils.mem import MemoryMeter as RefMeter  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.quantization import QuantizedTensor, quantize  # noqa: E402
from repro_torch.utils.mem import MemoryMeter  # noqa: E402

CHUNKS = (1000, 4096, 1 << 20)


def _dict(seed: int = 0, d: int = 64, layers: int = 3, vocab: int = 512):
    """A llama-shaped dict (embedding-dominated), as the reference's
    Table III benchmark builds it, at a small width."""
    rng = np.random.default_rng(seed)
    sd = {"embed_tokens": rng.standard_normal((vocab, d)).astype(np.float32)}
    for i in range(layers):
        sd[f"layers.{i}.attn"] = rng.standard_normal((d, d)).astype(np.float32)
        sd[f"layers.{i}.mlp"] = rng.standard_normal((4 * d, d)).astype(np.float32)
    sd["lm_head"] = rng.standard_normal((vocab, d)).astype(np.float32)
    return sd


class _Tap:
    """A loopback driver that also records each chunk's bytes and flags."""

    def __init__(self, inner):
        self.inner = inner
        self.frames = []

    def connect(self, on_chunk):
        self.inner.connect(on_chunk)

    def send(self, chunk):
        self.frames.append((chunk.seq, chunk.flags, bytes(b"".join(
            bytes(s) for s in chunk.segments))))
        self.inner.send(chunk)

    def flush(self):
        getattr(self.inner, "flush", lambda: None)()


def _run(mode, pkg, sd, chunk, tmp):
    """One transfer in ``mode`` through package ``pkg`` (``sm`` or
    ``ref_sm``); returns (meter, frames, received)."""
    ser_mod = ser if pkg is sm else ref_ser
    meter = MemoryMeter() if pkg is sm else RefMeter()
    tap = _Tap(pkg.LoopbackDriver())
    if mode == "file":   # the file to send exists before the transfer
        src = os.path.join(tmp, f"{pkg.__name__}.src")
        with open(src, "wb") as fh:
            fh.write(ser_mod.serialize_container(sd))
    with meter.activate():
        if mode == "regular":
            recv = pkg.BlobReceiver()
            tap.connect(recv.on_chunk)
            pkg.ObjectStreamer(tap, chunk).send_container(sd)
            got = recv.result
        elif mode == "container":
            recv = pkg.ContainerReceiver()
            tap.connect(recv.on_chunk)
            pkg.ContainerStreamer(tap, chunk).send_container(sd)
            got = recv.result
        else:
            out = os.path.join(tmp, f"{pkg.__name__}.out")
            recv = pkg.FileReceiver(out)
            tap.connect(recv.on_chunk)
            pkg.FileStreamer(tap, chunk).send_file(src)
            assert recv.done
            with open(out, "rb") as fh:
                got = ser_mod.deserialize_container(fh.read())
    return meter, tap.frames, got


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", ["regular", "container", "file"])
def test_modes_frame_decode_and_meter_like_the_reference(mode, chunk, tmp_path):
    sd = _dict()
    port_meter, port_frames, got = _run(mode, sm, sd, chunk, str(tmp_path))
    ref_meter, ref_frames, want = _run(mode, ref_sm, sd, chunk, str(tmp_path))
    assert port_frames == ref_frames
    assert port_frames[-1][1] & sm.FLAG_EOF
    assert list(got) == list(want) == list(sd)
    for name, arr in sd.items():
        assert np.asarray(got[name]).tobytes() == arr.tobytes() == \
            np.asarray(want[name]).tobytes()
    assert port_meter.as_dict() == ref_meter.as_dict()
    assert port_meter.live == 0


def test_table3_ordering_on_a_small_dict(tmp_path):
    """Regular = the whole blob three times (the sender's blob, the
    receiver's held segments, the one join); container = twice the
    largest item (the sender's views and the receiver's one buffer) plus
    that item's header segment, held until the buffer is allocated; file
    = two chunks (the sender's and the receiver's)."""
    sd = _dict(d=128, layers=4, vocab=2048)
    chunk = 1 << 14
    blob = len(ser.serialize_container(sd))
    name = max(sd, key=lambda n: sd[n].nbytes)
    views = ser.serialize_item_views(name, sd[name])
    peaks = {mode: _run(mode, sm, sd, chunk, str(tmp_path))[0].peak
             for mode in ("regular", "container", "file")}
    assert peaks["regular"] > peaks["container"] > peaks["file"]
    assert peaks["regular"] == 3 * blob
    assert peaks["container"] == 2 * ser.views_nbytes(views) + len(views[0])
    assert peaks["file"] == 2 * chunk


def test_quantized_dict_regular_and_container_carry_device_payloads():
    """QuantizedTensor items whose payloads are still torch tensors (what
    a quantize filter hands the wire) stream in both modes and decode to
    the reference's bytes."""
    sd = {n: quantize(torch.from_numpy(v), "blockwise8") for n, v in _dict(1).items()}
    wire = ser.serialize_container(sd)
    assert wire == ref_ser.serialize_container(ref_ser.deserialize_container(wire))
    for send, recv in ((sm.ObjectStreamer, sm.BlobReceiver()),
                       (sm.ContainerStreamer, sm.ContainerReceiver())):
        driver = sm.LoopbackDriver()
        driver.connect(recv.on_chunk)
        send(driver, 4096).send_container(sd)
        for name, qt in sd.items():
            got = recv.result[name]
            assert isinstance(got, QuantizedTensor) and got.fmt == "blockwise8"
            assert got.payload.tobytes() == qt.payload.numpy().tobytes()
            assert got.absmax.tobytes() == qt.absmax.numpy().tobytes()


@pytest.mark.parametrize("mode", ["regular", "container"])
def test_spool_driver_replays_on_flush_like_loopback(mode, tmp_path):
    """Frames go to disk, nothing is delivered until ``flush``, then the
    receiver gets exactly the loopback result, and the spool is empty."""
    sd = _dict(2)
    driver = sm.make_driver("spool", spool_dir=str(tmp_path / "spool"))
    recv = sm.BlobReceiver() if mode == "regular" else sm.ContainerReceiver()
    driver.connect(recv.on_chunk)
    streamer = sm.ObjectStreamer if mode == "regular" else sm.ContainerStreamer
    streamer(driver, 4096).send_container(sd)
    assert not recv.result and len(os.listdir(tmp_path / "spool")) > 1
    driver.flush()
    assert os.listdir(tmp_path / "spool") == []
    for name, arr in sd.items():
        assert np.asarray(recv.result[name]).tobytes() == arr.tobytes()


def test_driver_registry_after_this_slice():
    assert {"loopback", "spool", "tcp"} <= set(sm.registered_drivers())
    assert sm.NOT_PORTED_DRIVERS == ()
    sm.LoopbackDriver().flush()        # the base no-op
    tcp = sm.make_driver("tcp")        # the TCP driver is ported now
    assert isinstance(tcp, sm.TCPDriver)
    tcp.close()
    with pytest.raises(TypeError):
        sm.make_driver("spool")        # needs a directory
    with pytest.raises(ValueError, match="unknown driver"):
        sm.make_driver("carrier-pigeon")


def test_chunk_iter_slices_a_blob_like_the_reference():
    for blob in (b"", b"x", bytes(range(256)) * 40):
        for size in (1, 7, 256, 1 << 20):
            got = [(bytes(p), last) for p, last in sm._chunk_iter(blob, size)]
            want = [(bytes(p), last) for p, last in ref_sm._chunk_iter(blob, size)]
            assert got == want


@pytest.mark.parametrize("transmission", ["regular", "container"])
def test_simulator_over_the_spool_driver_equals_the_reference(transmission, tmp_path):
    """A federation whose every hop is spooled to disk and replayed on
    ``flush``: the same weights and the same wire bytes as the reference's
    simulator over its spool driver, and as the port over loopback."""
    from repro.fl.aggregator import FedAvgAggregator as RefFedAvg
    from repro.fl.executor import TrainExecutor as RefExecutor
    from repro.fl.simulator import FLSimulator as RefSimulator
    from repro.fl.simulator import SimulationConfig as RefConfig
    from repro_torch.fl.aggregator import FedAvgAggregator
    from repro_torch.fl.executor import TrainExecutor
    from repro_torch.fl.simulator import FLSimulator, SimulationConfig

    def executors(cls):
        def make(i):
            def train_fn(params, rnd):
                w = np.asarray(params["w"].numpy() if isinstance(params["w"], torch.Tensor)
                               else params["w"], np.float32)
                return {"w": w + np.float32(0.25 * (i + 1) * (rnd + 1))}, 2 + i, {}
            return cls(f"site-{i}", train_fn)
        return [make(i) for i in range(2)]

    init = {"w": np.linspace(-1, 1, 5000, dtype=np.float32)}
    outs = {}
    for driver in ("spool", "loopback"):
        cfg = SimulationConfig(num_rounds=2, transmission=transmission, chunk_size=4096,
                               driver=driver, spool_dir=str(tmp_path / f"port-{driver}"))
        sim = FLSimulator(executors(TrainExecutor), FedAvgAggregator(device="cpu"), cfg,
                          pipelines={}, device="cpu")
        outs[driver] = (sim.run(dict(init))["w"].numpy(), sim.stats.bytes_sent)
    ref_sim = RefSimulator(executors(RefExecutor), RefFedAvg(), RefConfig(
        num_rounds=2, transmission=transmission, chunk_size=4096, driver="spool",
        spool_dir=str(tmp_path / "ref")))
    want = np.asarray(ref_sim.run(dict(init))["w"])
    for got, nbytes in outs.values():
        assert got.tobytes() == want.tobytes()
        assert nbytes == ref_sim.stats.bytes_sent
    assert os.listdir(tmp_path / "port-spool") == []
    with pytest.raises(ValueError, match="spool_dir"):
        FLSimulator(executors(TrainExecutor), FedAvgAggregator(device="cpu"),
                    SimulationConfig(driver="spool"), pipelines={}, device="cpu").run(dict(init))
