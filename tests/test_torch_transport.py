"""Port parity, the TCP transport of ``core/streaming.py``: the
point-to-point ``TCPDriver``, the federation's ``Connection`` (JSON
control frames and raw chunk streams on one socket), ``ConnectionDriver``,
``StreamDemux`` and the concurrent ``TCPServer`` — over real sockets on
127.0.0.1 with ephemeral ports, against ``repro.core.streaming``.

Every comparison is bitwise: the frames a port streamer puts on a socket
are the reference streamer's frames (headers, payload bytes, item and
end-of-stream flags), each package's receiver reassembles the other's
stream, and ``run_job`` over ``"driver": "tcp"`` gives the weights,
traffic totals and per-round messages of ``"driver": "loopback"``.
"""
import json
import socket
import struct
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import streaming as ref_sm  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LIVE_SMOKE = json.loads((ROOT / "examples" / "jobs" / "live_smoke.json").read_text())


def _sd(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((128, 32)).astype(np.float32),
            "w1": rng.standard_normal((64, 64)).astype(np.float32),
            "w2": rng.standard_normal((32,)).astype(np.float32)}


class _Tap:
    """A driver that keeps every frame's encoded bytes."""

    def __init__(self):
        self.frames = []

    def connect(self, on_chunk):
        pass

    def send(self, chunk):
        self.frames.append(chunk.encode())


def _frames(streamer_mod, mode, sd, chunk_size):
    tap = _Tap()
    streamer = (streamer_mod.ContainerStreamer if mode == "container"
                else streamer_mod.ObjectStreamer)
    streamer(tap, chunk_size).send_container(sd)
    return tap.frames


def _strip_sid(frames):
    """Frames without their random 16-byte stream ids."""
    return [f[16:] for f in frames]


@pytest.mark.parametrize("mode", ["container", "regular"])
@pytest.mark.parametrize("chunk_size", [256, 4096, 1 << 20])
def test_chunk_frames_are_the_reference_frames(mode, chunk_size):
    sd = _sd(1)
    assert _strip_sid(_frames(sm, mode, sd, chunk_size)) == \
        _strip_sid(_frames(ref_sm, mode, sd, chunk_size))


@pytest.mark.parametrize("sender,receiver", [(ref_sm, sm), (sm, ref_sm)],
                         ids=["reference-to-port", "port-to-reference"])
@pytest.mark.parametrize("mode", ["container", "regular"])
def test_tcp_driver_carries_the_other_package_streams(sender, receiver, mode):
    sd = _sd(2)
    driver = receiver.TCPDriver()
    recv = receiver.ContainerReceiver() if mode == "container" else receiver.BlobReceiver()
    driver.connect(recv.on_chunk)
    streamer = sender.ContainerStreamer if mode == "container" else sender.ObjectStreamer
    streamer(driver, 512).send_container(sd)
    driver.close()
    assert set(recv.result) == set(sd)
    for name, arr in sd.items():
        assert np.asarray(recv.result[name]).tobytes() == arr.tobytes()


def test_send_chunk_gathers_and_coalesces_the_same_bytes():
    payload = (memoryview(b"a" * 5000), memoryview(b"b" * 70000))
    chunk = sm.Chunk(b"s" * 16, 3, payload, sm.FLAG_ITEM_END)
    for coalesce in (1, 1 << 20):
        a, b = socket.socketpair()
        with a, b:
            t = threading.Thread(target=sm.send_chunk, args=(a, chunk, coalesce))
            t.start()
            want = chunk.encode()
            got = bytearray()
            while len(got) < len(want):
                got.extend(b.recv(1 << 16))
            t.join()
        assert bytes(got) == want == ref_sm.Chunk(b"s" * 16, 3, payload,
                                                  ref_sm.FLAG_ITEM_END).encode()
    with socket.socket() as s:
        assert sm.socket_coalesce_bytes(s) == ref_sm.socket_coalesce_bytes(s)
    assert (sm.COALESCE_CAP, sm.TCPDriver.COALESCE_BYTES, sm.CTRL_MAX_BYTES) == \
        (ref_sm.COALESCE_CAP, ref_sm.TCPDriver.COALESCE_BYTES, ref_sm.CTRL_MAX_BYTES)


def test_tcp_driver_closed_without_traffic_and_closed_twice():
    for mod in (sm, ref_sm):
        driver = mod.TCPDriver()
        driver.connect(lambda c: None)
        driver.close()
        driver.close()
        assert driver._thread is None
        idle = mod.TCPDriver()          # never connected: close is still clean
        idle.close()


def test_eight_concurrent_transfers():
    results, errors = {}, []

    def transfer(i):
        try:
            driver = sm.TCPDriver()
            recv = sm.ContainerReceiver()
            driver.connect(recv.on_chunk)
            sm.ContainerStreamer(driver, 1024).send_container(_sd(i))
            driver.close()
            results[i] = recv.result
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=transfer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(results) == 8
    for i, got in results.items():
        for name, arr in _sd(i).items():
            assert np.asarray(got[name]).tobytes() == arr.tobytes()


# ---------------------------------------------------------------------------
# Connection: control frames, chunk streams, protocol errors
# ---------------------------------------------------------------------------

def _pair(a_mod, b_mod):
    a, b = socket.socketpair()
    return a_mod.Connection(a, ("a", 0)), b_mod.Connection(b, ("b", 0))


@pytest.mark.parametrize("a_mod,b_mod", [(sm, ref_sm), (ref_sm, sm)],
                         ids=["port-to-reference", "reference-to-port"])
def test_connection_control_frames_and_streams_cross_packages(a_mod, b_mod):
    a, b = _pair(a_mod, b_mod)
    with a.sock, b.sock:
        msg = {"type": "hello", "client": "site-0", "epoch": 3, "proto": 1}
        a.send_ctrl(msg)
        assert b.recv_ctrl() == msg
        body = json.dumps(msg, sort_keys=True).encode()
        # the bytes of one control frame: u32 length + sorted JSON
        a.send_ctrl(msg)
        assert b._read_exact(4 + len(body)) == struct.pack("<I", len(body)) + body
        sd = _sd(4)
        t = threading.Thread(
            target=lambda: a_mod.ContainerStreamer(a_mod.ConnectionDriver(a), 300)
            .send_container(sd))
        t.start()
        recv = b_mod.ContainerReceiver()
        nbytes = b.recv_stream(recv.on_chunk)
        t.join()
        assert nbytes == sum(len(f) for f in _frames(sm, "container", sd, 300))
        for name, arr in sd.items():
            assert np.asarray(recv.result[name]).tobytes() == arr.tobytes()


def test_protocol_errors_match_the_reference():
    for mod in (sm, ref_sm):
        a, b = _pair(mod, mod)
        with a.sock, b.sock:
            a.sock.sendall(struct.pack("<I", mod.CTRL_MAX_BYTES + 1))
            with pytest.raises(mod.ProtocolError, match="control frame declares"):
                b.recv_ctrl()
        a, b = _pair(mod, mod)
        with a.sock, b.sock:
            a.sock.sendall(struct.pack("<I", 5) + b"{nope")
            with pytest.raises(mod.ProtocolError, match="not JSON"):
                b.recv_ctrl()
        a, b = _pair(mod, mod)
        with b.sock:
            a.sock.sendall(struct.pack("<I", 10) + b"{}")
            a.close()
            with pytest.raises(ConnectionError, match="closed the connection mid-frame"):
                b.recv_ctrl()
    assert issubclass(sm.ProtocolError, ValueError)


def test_read_exact_keeps_its_bytes_across_a_timeout():
    """A timeout mid-frame leaves the read bytes in the connection's
    buffer, and the next read completes the same frame."""
    a, b = _pair(sm, sm)
    with a.sock, b.sock:
        msg = {"type": "result", "round": 2, "pad": "x" * 100}
        body = json.dumps(msg, sort_keys=True).encode()
        frame = struct.pack("<I", len(body)) + body
        a.sock.sendall(frame[:40])
        b.settimeout(0.2)
        with pytest.raises(TimeoutError):
            b.recv_ctrl()
        a.sock.sendall(frame[40:])
        assert b.recv_ctrl() == msg
        chunk = sm.Chunk(b"q" * 16, 0, b"z" * 500, sm.FLAG_EOF)
        enc = chunk.encode()
        a.sock.sendall(enc[:10])              # inside the chunk header
        with pytest.raises(TimeoutError):
            b.recv_chunk()
        a.sock.sendall(enc[10:300])           # inside the payload
        with pytest.raises(TimeoutError):
            b.recv_chunk()
        a.sock.sendall(enc[300:])
        got = b.recv_chunk()
        assert (got.stream_id, got.seq, bytes(got.payload), got.flags) == \
            (chunk.stream_id, 0, b"z" * 500, sm.FLAG_EOF)


def test_stream_demux_routes_interleaved_streams():
    sds = {i: _sd(10 + i) for i in range(3)}
    streams = {}
    for i, sd in sds.items():
        tap = _Tap()
        sm.ContainerStreamer(tap, 512).send_container(sd)
        streams[i] = [sm.Chunk.decode(f) for f in tap.frames]
    made = []

    def factory(sid):
        made.append(sid)
        return sm.ContainerReceiver()

    demux = sm.StreamDemux(factory)
    done = []
    order = [(i, k) for k in range(max(map(len, streams.values())))
             for i in streams if k < len(streams[i])]
    for i, k in order:
        out = demux.route(streams[i][k])
        if out is not None:
            done.append((i, out))
    assert demux.open_streams == 0 and len(made) == 3
    for i, recv in done:
        for name, arr in sds[i].items():
            assert np.asarray(recv.result[name]).tobytes() == arr.tobytes()


def test_tcp_server_hands_each_connection_to_its_own_thread():
    seen, lock = [], threading.Lock()

    def on_connection(conn):
        msg = conn.recv_ctrl()
        with lock:
            seen.append(msg["i"])
        conn.send_ctrl({"echo": msg["i"]})
        conn.close()

    server = sm.TCPServer()
    server.serve(on_connection)
    with pytest.raises(RuntimeError, match="already called"):
        server.serve(on_connection)
    try:
        for i in range(5):
            conn = ref_sm.Connection(socket.create_connection(server.address))
            conn.send_ctrl({"i": i})
            assert conn.recv_ctrl() == {"echo": i}
            conn.close()
    finally:
        server.close()
    assert sorted(seen) == list(range(5)) and server.accepted == 5


# ---------------------------------------------------------------------------
# the simulator over the tcp driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_init():
    from repro.fl import job as ref_job

    spec = {**LIVE_SMOKE, "rounds": 1}
    return {k: np.asarray(v) for k, v in ref_job.initial_weights(spec).items()}


def test_run_job_over_tcp_equals_loopback(live_init):
    assert sm.NOT_PORTED_DRIVERS == () and "tcp" in sm.registered_drivers()
    runs = {}
    for driver in ("loopback", "tcp"):
        spec = {**LIVE_SMOKE, "rounds": 1, "driver": driver}
        jb = port_job.build_job(spec, device="cpu", weights=live_init)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = testing.fixed_train_fn(live_init, i, 0.05 * (i + 1))
        runs[driver] = (jb.run(), jb.sim.stats.as_dict())
    (loop, loop_stats), (tcp, tcp_stats) = runs["loopback"], runs["tcp"]
    assert tcp_stats == loop_stats and tcp["messages"] == loop["messages"] == 8
    for name, w in loop["final_weights"].items():
        assert torch.equal(tcp["final_weights"][name], w)
