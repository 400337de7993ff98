"""Port parity, ``core/resilience.py`` and the simulator's chunk faults,
against ``repro.core.resilience`` and ``repro.fl.simulator``.

* ``LossyDriver`` draws its faults from ``random.Random(seed)``: one seed
  (an int, or the simulator's string key) gives the same drops,
  duplicates and reorders — the same delivered sequence of chunks — in
  both packages, and ``ReliableTransfer`` the same ``retransmits``.
* ``OrderedDeliveryBuffer`` dedups and releases in order; a reliable
  transfer through every fault mix reassembles bitwise.
* ``ChaosProxy`` between real sockets: a corrupt plan flips exactly one
  byte then forwards clean, stall delays losslessly, blackhole drops
  the connection, throttle paces, and a seeded offset is the
  reference's.
* The simulator: ``examples/jobs/live_smoke.json`` at smoke width with
  ``chunk_drop_prob=0.2``, ``chunk_dup_prob=0.1``,
  ``chunk_reorder_window=4`` and fixed updates gives the reference's
  ``TrafficStats`` (retransmits included, and > 0) and bitwise its
  weights; chunk faults over the tcp driver raise in both.
"""
import json
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import resilience as ref_rs  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.fl import job as ref_job  # noqa: E402
from repro.fl import simulator as ref_sim  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import resilience as rs  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402
from repro_torch.fl import simulator as port_sim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LIVE_SMOKE = json.loads((ROOT / "examples" / "jobs" / "live_smoke.json").read_text())
FAULTS = {"chunk_drop_prob": 0.2, "chunk_dup_prob": 0.1, "chunk_reorder_window": 4}


def _sd(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((128, 32)).astype(np.float32),
            "w1": rng.standard_normal((64, 64)).astype(np.float32),
            "w2": rng.standard_normal((32,)).astype(np.float32)}


class _Record:
    def __init__(self):
        self.seqs = []

    def connect(self, on_chunk):
        pass

    def send(self, chunk):
        self.seqs.append(chunk.seq)

    def flush(self):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("seed", [7, "wirefault:0:site-1:task_result:1"])
def test_lossy_driver_draws_the_reference_faults(seed):
    kw = dict(drop_prob=0.25, dup_prob=0.2, reorder_window=5, seed=seed)
    delivered = []
    for mod, smod in ((rs, sm), (ref_rs, ref_sm)):
        inner = _Record()
        d = mod.LossyDriver(inner, **kw)
        for i in range(60):
            d.send(smod.Chunk(b"x" * 16, i, b"p"))
        d.flush()
        delivered.append(inner.seqs)
    assert delivered[0] == delivered[1]
    assert len(set(delivered[0])) < 60 < len(delivered[0]) + 60   # drops happened


def test_ordered_buffer_reorders_dedups_and_reports_gaps():
    seen = []
    buf = rs.OrderedDeliveryBuffer(lambda c: seen.append(c.seq))
    chunks = [sm.Chunk(b"x" * 16, i, b"p", sm.FLAG_EOF if i == 4 else 0) for i in range(5)]
    for c in (chunks[2], chunks[0], chunks[0], chunks[1], chunks[4], chunks[3]):
        buf.on_chunk(c)
    assert seen == [0, 1, 2, 3, 4] and buf.complete and not buf.missing()
    gaps = rs.OrderedDeliveryBuffer(lambda c: None)
    gaps.on_chunk(sm.Chunk(b"x" * 16, 0, b"p", 0))
    gaps.on_chunk(sm.Chunk(b"x" * 16, 3, b"p", sm.FLAG_EOF))
    assert gaps.missing() == {1, 2}


@pytest.mark.parametrize(
    "drop,dup,reorder", [(0.3, 0.0, 0), (0.0, 0.4, 0), (0.0, 0.0, 5), (0.25, 0.25, 4)])
@pytest.mark.parametrize("mode", ["container", "regular"])
def test_reliable_transfer_repairs_like_the_reference(drop, dup, reorder, mode):
    sd = _sd()
    retransmits = []
    for mod, smod in ((rs, sm), (ref_rs, ref_sm)):
        driver = mod.LossyDriver(smod.LoopbackDriver(), drop_prob=drop, dup_prob=dup,
                                 reorder_window=reorder, seed=11)
        recv = smod.ContainerReceiver() if mode == "container" else smod.BlobReceiver()
        xfer = mod.ReliableTransfer(driver, chunk_size=256)
        assert xfer.send_container(sd, recv, mode=mode)
        for k, v in sd.items():
            assert np.asarray(recv.result[k]).tobytes() == v.tobytes()
        retransmits.append(xfer.retransmits)
    assert retransmits[0] == retransmits[1]
    assert (retransmits[0] > 0) == (drop > 0)


# ---------------------------------------------------------------------------
# ChaosProxy
# ---------------------------------------------------------------------------

def _echo_server():
    srv = socket.create_server(("127.0.0.1", 0))

    def serve(c):
        with c:
            while data := c.recv(1 << 16):
                c.sendall(data)

    def accept():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(c,), daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()
    return srv


def _roundtrip(addr, payload, want=None, timeout=10.0):
    want = len(payload) if want is None else want
    with socket.create_connection(addr, timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(payload)
        got = b""
        while len(got) < want:
            data = s.recv(1 << 16)
            if not data:
                break
            got += data
    return got


def _proxied(plan):
    srv = _echo_server()
    return srv, rs.ChaosProxy(srv.getsockname(), plan).start()


def test_chaos_proxy_corrupt_flips_exactly_one_byte_then_runs_clean():
    srv, proxy = _proxied({"kind": "corrupt", "after_bytes": 100, "xor": 0x01})
    try:
        payload = bytes(range(256))
        got = _roundtrip(proxy.address, payload)
        assert got[100] == payload[100] ^ 0x01
        assert got[:100] == payload[:100] and got[101:] == payload[101:]
        assert _roundtrip(proxy.address, payload) == payload     # triggers spent
        assert proxy.connections == 2 and proxy.triggered == 1
    finally:
        proxy.close()
        srv.close()


def test_chaos_proxy_stall_blackhole_and_throttle():
    srv, proxy = _proxied({"kind": "stall", "after_bytes": 50, "stall_s": 0.5})
    try:
        t0 = time.monotonic()
        assert _roundtrip(proxy.address, bytes(200)) == bytes(200)
        assert time.monotonic() - t0 >= 0.4
    finally:
        proxy.close()
        srv.close()
    srv, proxy = _proxied({"kind": "blackhole", "after_bytes": 50})
    try:
        assert len(_roundtrip(proxy.address, bytes(200), want=200)) <= 50
    finally:
        proxy.close()
        srv.close()
    srv, proxy = _proxied({"kind": "throttle", "after_bytes": 0, "bps": 200_000})
    try:
        t0 = time.monotonic()
        assert _roundtrip(proxy.address, bytes(200_000)) == bytes(200_000)
        assert time.monotonic() - t0 >= 0.3
    finally:
        proxy.close()
        srv.close()


def test_chaos_proxy_seeded_offset_is_the_reference():
    for seed in (0, 7, 8):
        a = rs.ChaosProxy(("127.0.0.1", 1), {"kind": "stall", "seed": seed})
        b = ref_rs.ChaosProxy(("127.0.0.1", 1), {"kind": "stall", "seed": seed})
        try:
            assert a.plan["after_bytes"] == b.plan["after_bytes"]
            assert (1 << 10) <= a.plan["after_bytes"] < (1 << 16)
        finally:
            a.close()
            b.close()
    srv, proxy = _proxied({})
    try:
        with pytest.raises(RuntimeError, match="already called"):
            proxy.start()
    finally:
        proxy.close()
        srv.close()


# ---------------------------------------------------------------------------
# the simulator's chunk faults
# ---------------------------------------------------------------------------

def test_simulator_chunk_faults_match_the_reference():
    spec = {**LIVE_SMOKE, "clients": 3}
    init = {k: np.asarray(v) for k, v in ref_job.initial_weights(spec).items()}
    outs = {}
    for tag, job, kw in (("port", port_job, {"device": "cpu", "weights": init}),
                         ("ref", ref_job, {})):
        jb = job.build_job(spec, **kw)
        for key, value in FAULTS.items():
            setattr(jb.sim.config, key, value)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = testing.fixed_train_fn(init, i, 0.05 * (i + 1))
        outs[tag] = (jb.run()["final_weights"], jb.sim.stats.as_dict())
    (port_w, port_stats), (ref_w, ref_stats) = outs["port"], outs["ref"]
    assert port_stats == ref_stats and port_stats["retransmits"] > 0
    assert set(port_w) == set(ref_w)
    for k, w in ref_w.items():
        assert port_w[k].numpy().tobytes() == np.asarray(w).tobytes()


def test_chunk_faults_over_tcp_raise_in_both_packages():
    for mod in (port_sim, ref_sim):
        cfg = mod.SimulationConfig(driver="tcp", chunk_drop_prob=0.1)
        assert cfg.faulty
        with pytest.raises(ValueError, match="not supported over the tcp driver"):
            mod._Wire(cfg, mod.TrafficStats())
    assert not port_sim.SimulationConfig().faulty
