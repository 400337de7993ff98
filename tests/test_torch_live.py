"""Port parity, the live federation plane (``launch/federation.py``) over
real TCP on 127.0.0.1, in process: a ``FederationServer`` on the CPU and
``FederationClient`` threads.

* ``examples/jobs/live_smoke.json`` at smoke width (4 clients, 2 rounds,
  blockwise8 + crc32 uplink, streaming int8 fold) with fixed updates
  (``repro_torch.testing.fixed_train_fn``): ordered uplinks give weights
  bitwise-equal to the port's ``run_job`` and to the reference's
  ``run_job`` on the same updates — with port clients on a port server,
  port clients on a reference server, and reference clients on a port
  server.
* A concurrent uplink agrees with the simulator within rtol 1e-5, the
  tolerance of the reference's
  ``test_live_concurrent_uplink_completes_and_agrees``.
* The handshake rejects a wrong fingerprint, a stale epoch, an unknown
  client, a foreign protocol revision and a duplicate; a rejected
  client raises.
* A client killed mid-uplink contributes zero weight (the poisoned fold
  restarts over the survivors, bitwise their aggregate), and a crashed
  client rejoins at the current epoch.
* ``pipeline_fingerprint`` equals the reference's for every example
  spec (or both packages refuse the spec alike), and ``live_spec``
  refuses what the reference refuses.
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

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.fl import job as ref_job  # noqa: E402
from repro.launch import federation as ref_fed  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import pipeline as port_pl  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.fl.aggregator import FedAvgAggregator  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402
from repro_torch.fl.controller import make_task  # noqa: E402
from repro_torch.fl.executor import TrainExecutor  # noqa: E402
from repro_torch.fl.simulator import FLSimulator, SimulationConfig  # noqa: E402
from repro_torch.launch import federation as fed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOBS = ROOT / "examples" / "jobs"
LIVE_SMOKE = json.loads((JOBS / "live_smoke.json").read_text())
W_TRUE = np.arange(1, 9, dtype=np.float32) / 8.0
STACK = ["quantize:blockwise8", "crc32"]
INIT = {"w": np.zeros(8, np.float32)}


@pytest.fixture(autouse=True)
def _package_stages_only(monkeypatch):
    """Each stage registry as its package defines it. The handshake
    fingerprints the registry, and other test files of this worker may
    have registered test stages into the reference's
    (``tests/test_pipeline.py``, ``tests/test_wire_golden.py``)."""
    for mod in (ref_pl, port_pl):
        monkeypatch.setattr(mod, "_STAGES", {
            name: stage for name, stage in mod._STAGES.items()
            if stage.__module__.split(".")[0] in ("repro", "repro_torch")})


@pytest.fixture(scope="module")
def live_init():
    return {k: np.asarray(v) for k, v in ref_job.initial_weights(LIVE_SMOKE).items()}


@pytest.fixture(scope="module")
def want(live_init):
    """The reference's run_job of live_smoke.json with fixed updates."""
    jb = ref_job.build_job(LIVE_SMOKE)
    for i, proxy in enumerate(jb.sim.proxies):
        proxy.executor.train_fn = testing.fixed_train_fn(live_init, i, 0.05 * (i + 1))
    return {k: np.asarray(v) for k, v in jb.run()["final_weights"].items()}


def _lsq_executor(name, seed, n=128, lr=0.3, local_steps=3, sleep_s=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, W_TRUE.size)).astype(np.float32)
    y = X @ W_TRUE

    def train_fn(params, rnd):
        if sleep_s:
            time.sleep(sleep_s)
        w = np.asarray(params["w"]).copy()
        for _ in range(local_steps):
            w = w - lr * (X.T @ (X @ w - y) / n)
        return {"w": w}, n, {}

    return TrainExecutor(name, train_fn)


def _spec(clients=3, rounds=2, stack=STACK):
    return {"clients": clients, "rounds": rounds, "chunk_mb": 1,
            "pipeline": {"task_data": list(stack), "task_result": list(stack)}}


def _start(clients):
    errors, threads = [], []
    for client in clients:
        def run(c=client):
            try:
                c.run()
            except Exception as exc:  # noqa: BLE001 - surfaced by the test
                errors.append(exc)

        t = threading.Thread(target=run, daemon=True, name=f"live-{client.name}")
        t.start()
        threads.append(t)
    return threads, errors


def _join(threads, timeout=60):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "client thread wedged"


def _lsq_clients(server, executors, **kwargs):
    pipelines = fed.build_pipelines_from_spec(server.spec, device="cpu")
    return [fed.FederationClient(name=ex.name, executor=ex, pipelines=pipelines,
                                 address=server.address, fingerprint=server.fingerprint,
                                 timeout_s=60.0, **kwargs) for ex in executors]


def _run(server, clients, init):
    try:
        threads, errors = _start(clients)
        out = server.run(dict(init))
        _join(threads)
        assert not errors, errors
    finally:
        server.close()
    return out


def _bitwise(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k


# ---------------------------------------------------------------------------
# live == run_job, bitwise, within and across packages
# ---------------------------------------------------------------------------

def _port_fixed_clients(server, init):
    clients = []
    for i in range(server.n_clients):
        c = fed.FederationClient.for_spec(LIVE_SMOKE, i, server.address,
                                          timeout_s=60.0, device="cpu")
        c.executor.train_fn = testing.fixed_train_fn(init, i, 0.05 * (i + 1))
        clients.append(c)
    return clients


def _ref_fixed_clients(server, init):
    clients = []
    for i in range(server.n_clients):
        c = ref_fed.FederationClient.for_spec(LIVE_SMOKE, i, server.address, timeout_s=60.0)
        c.executor.train_fn = testing.fixed_train_fn(init, i, 0.05 * (i + 1))
        clients.append(c)
    return clients


def test_live_ordered_rounds_bitwise_match_both_run_jobs(live_init, want):
    server = fed.FederationServer(LIVE_SMOKE, join_timeout_s=60, device="cpu").start()
    live = _run(server, _port_fixed_clients(server, live_init), live_init)
    _bitwise(live, want)
    jb = port_job.build_job(LIVE_SMOKE, device="cpu", weights=live_init)
    for i, proxy in enumerate(jb.sim.proxies):
        proxy.executor.train_fn = testing.fixed_train_fn(live_init, i, 0.05 * (i + 1))
    port_sim = jb.run()["final_weights"]
    assert fed.weights_bitwise_equal(live, port_sim)
    assert [r["clients"] for r in server.round_log] == [[f"site-{i}" for i in range(4)]] * 2
    assert server.restarts == 0 and server.bytes_up > 0 and server.bytes_down > 0
    n_items = len(live_init)
    assert server.uplink_log == [
        {"round": r, "client": f"site-{i}", "granted": True, "items": n_items,
         "outcome": "folded"} for r in range(2) for i in range(4)]
    # on the card: one B1 an uplink, and the spec's dense fedavg
    # dequantizes every folded item (B2)
    assert testing.live_launches(LIVE_SMOKE, server.uplink_log) == {
        "quantize_blockwise8": 8, "dequantize_blockwise8": 8 * n_items}
    assert testing.live_launches({**LIVE_SMOKE, "aggregator": "quantized-fedavg"},
                                 server.uplink_log) == {
        "quantize_blockwise8": 8, "dequant_accumulate8_into": 8 * n_items}


def test_reference_server_with_port_clients(live_init, want):
    server = ref_fed.FederationServer(LIVE_SMOKE, join_timeout_s=60).start()
    assert server.fingerprint == fed.pipeline_fingerprint(
        fed.build_pipelines_from_spec(LIVE_SMOKE, device="cpu"),
        fed.aggregator_spec(LIVE_SMOKE))
    _bitwise(_run(server, _port_fixed_clients(server, live_init), live_init), want)


def test_port_server_with_reference_clients(live_init, want):
    server = fed.FederationServer(LIVE_SMOKE, join_timeout_s=60, device="cpu").start()
    _bitwise(_run(server, _ref_fixed_clients(server, live_init), live_init), want)


def test_live_concurrent_uplink_completes_and_agrees():
    spec = _spec(clients=3, rounds=2)
    server = fed.FederationServer(spec, uplink="concurrent", join_timeout_s=30,
                                  device="cpu").start()
    live = _run(server, _lsq_clients(server, [_lsq_executor(f"site-{i}", i)
                                              for i in range(3)]), INIT)
    sim = FLSimulator([_lsq_executor(f"site-{i}", i) for i in range(3)],
                      FedAvgAggregator(device="cpu"),
                      SimulationConfig(num_rounds=2, transmission="container"),
                      pipelines={d: fed.build_pipelines_from_spec(spec, device="cpu")[d]
                                 for d in ("task_data", "task_result")},
                      server_streaming_agg=True, device="cpu")
    expected = sim.run(dict(INIT))
    np.testing.assert_allclose(live["w"].numpy(), expected["w"].numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# handshake: fail fast, never mid-fold
# ---------------------------------------------------------------------------

def _hello(server, **over):
    conn = sm.Connection(socket.create_connection(server.address))
    try:
        msg = {"type": "hello", "client": "site-0", "epoch": 0,
               "proto": fed.PROTO, "fingerprint": server.fingerprint}
        msg.update(over)
        conn.send_ctrl(msg)
        return conn.recv_ctrl()
    finally:
        conn.close()


def test_handshake_rejects_fingerprint_epoch_unknown_proto_and_duplicate():
    server = fed.FederationServer(_spec(clients=2), device="cpu").start()
    try:
        other = _spec(stack=["zlib"])
        wrong = fed.pipeline_fingerprint(fed.build_pipelines_from_spec(other, device="cpu"),
                                         fed.aggregator_spec(other))
        assert wrong != server.fingerprint
        resp = _hello(server, fingerprint=wrong)
        assert resp["type"] == "reject" and "fingerprint mismatch" in resp["reason"]
        resp = _hello(server, epoch=5)
        assert resp["type"] == "reject" and resp["code"] == "stale-epoch"
        assert resp["round"] == 0 and "stale round epoch" in resp["reason"]
        resp = _hello(server, client="site-9")
        assert resp["type"] == "reject" and "unknown client" in resp["reason"]
        resp = _hello(server, proto=99)
        assert resp["type"] == "reject" and "protocol revision" in resp["reason"]
        held = sm.Connection(socket.create_connection(server.address))
        try:
            held.send_ctrl({"type": "hello", "client": "site-0", "epoch": 0,
                            "proto": fed.PROTO, "fingerprint": server.fingerprint})
            assert held.recv_ctrl()["type"] == "welcome"
            resp = _hello(server)
            assert resp["type"] == "reject" and "duplicate" in resp["reason"]
        finally:
            held.close()
        assert [r["code"] for r in server.rejects] == [
            "fingerprint", "stale-epoch", "unknown-client", "proto", "duplicate"]
        bad = fed.FederationClient(
            name="site-1", executor=_lsq_executor("site-1", 1),
            pipelines=fed.build_pipelines_from_spec(other, device="cpu"),
            address=server.address, fingerprint="0" * 16)
        with pytest.raises(RuntimeError, match="fingerprint mismatch"):
            bad.run()
    finally:
        server.close()


# ---------------------------------------------------------------------------
# crash mid-uplink, rejoin
# ---------------------------------------------------------------------------

def _expected_rounds(executors, rounds, init):
    agg = FedAvgAggregator(device="cpu")
    w = dict(init)
    for rnd in range(rounds):
        for ex in executors:
            agg.accept(ex.execute(make_task(rnd, w)))
        w = {k: v.numpy() for k, v in agg.finish().items()}
    return w


def _encode_result_frames(pipelines, name, payload):
    pipeline = pipelines["task_result"]
    msg = Message(MessageKind.TASK_RESULT, dict(payload),
                  {"round": 0, "client": name, "num_samples": 128})
    enc, ctx = pipeline.begin_encode(msg)
    frames = []

    class _Cap:
        def send(self, chunk):
            frames.append(chunk.encode())

    sm.ContainerStreamer(_Cap(), 1 << 20).send_items(
        pipeline.iter_encode_views(enc, ctx), pipeline.n_items(enc))
    return frames


def _handshake_and_grant(server, name):
    conn = sm.Connection(socket.create_connection(server.address))
    conn.send_ctrl({"type": "hello", "client": name, "epoch": 0,
                    "proto": fed.PROTO, "fingerprint": server.fingerprint})
    assert conn.recv_ctrl()["type"] == "welcome"
    assert conn.recv_ctrl()["type"] == "task"
    conn.recv_stream(lambda c: None)
    assert conn.recv_ctrl()["type"] == "grant"
    conn.send_ctrl({"type": "result", "round": 0, "client": name})
    return conn


def test_client_killed_mid_uplink_contributes_zero_weight():
    spec = _spec(clients=3, rounds=2, stack=[])
    server = fed.FederationServer(spec, join_timeout_s=30, round_timeout_s=30,
                                  device="cpu").start()
    pipelines = fed.build_pipelines_from_spec(spec, device="cpu")

    def saboteur():
        conn = _handshake_and_grant(server, "site-2")
        try:
            frames = _encode_result_frames(
                pipelines, "site-2", {"a": np.full(8, 100.0, np.float32),
                                      "w": np.full(8, 100.0, np.float32)})
            conn.sock.sendall(frames[0] + frames[1])   # meta + one item, then dies
        finally:
            conn.close()

    sab = threading.Thread(target=saboteur, daemon=True)
    sab.start()
    live = _run(server, _lsq_clients(server, [_lsq_executor(f"site-{i}", i)
                                              for i in range(2)]), INIT)
    sab.join(timeout=30)
    _bitwise(live, _expected_rounds([_lsq_executor(f"site-{i}", i) for i in range(2)],
                                    2, INIT))
    assert server.restarts == 1 and "a" not in live
    assert [r["clients"] for r in server.round_log] == [["site-0", "site-1"]] * 2
    lost = [e for e in server.uplink_log if e["client"] == "site-2"]
    assert lost == [{"round": 0, "client": "site-2", "granted": True, "items": 1,
                     "outcome": "lost"}]


def test_crashed_client_rejoins_at_current_epoch():
    spec = _spec(clients=3, rounds=5, stack=[])
    server = fed.FederationServer(spec, join_timeout_s=30, round_timeout_s=30,
                                  device="cpu").start()
    pipelines = fed.build_pipelines_from_spec(spec, device="cpu")

    def die_after_round0():
        conn = _handshake_and_grant(server, "site-2")
        try:
            for f in _encode_result_frames(pipelines, "site-2",
                                           {"w": np.zeros(8, np.float32)}):
                conn.sock.sendall(f)
        finally:
            conn.close()

    rejoined = threading.Event()

    def rejoin():
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            client = fed.FederationClient(
                name="site-2", executor=_lsq_executor("site-2", 2), pipelines=pipelines,
                address=server.address, fingerprint=server.fingerprint,
                epoch=server.current_round, timeout_s=60.0)
            try:
                client.run()
            except (RuntimeError, OSError, ConnectionError):
                time.sleep(0.02)
                continue
            rejoined.set()
            return

    clients = _lsq_clients(server, [_lsq_executor(f"site-{i}", i, sleep_s=0.15)
                                    for i in range(2)])
    try:
        threads, errors = _start(clients)
        t_dead = threading.Thread(target=die_after_round0, daemon=True)
        t_dead.start()
        server.wait_for_clients()
        t_rejoin = threading.Thread(target=rejoin, daemon=True)
        t_rejoin.start()
        live = server.run(dict(INIT))
        _join(threads)
        t_dead.join(timeout=30)
        t_rejoin.join(timeout=30)
        assert not errors
    finally:
        server.close()
    assert rejoined.is_set()
    log = server.round_log
    assert log[0]["clients"] == ["site-0", "site-1", "site-2"]
    assert any(r["clients"] == ["site-0", "site-1"] for r in log)
    assert log[-1]["clients"] == ["site-0", "site-1", "site-2"]
    assert torch.isfinite(live["w"]).all()


# ---------------------------------------------------------------------------
# fingerprints and live_spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(JOBS.glob("*.json")), ids=lambda p: p.stem)
def test_pipeline_fingerprint_equals_the_reference(path):
    spec = json.loads(path.read_text())
    try:
        want = ref_fed.pipeline_fingerprint(ref_fed.build_pipelines_from_spec(spec),
                                            ref_fed.aggregator_spec(spec))
    except ValueError as exc:
        with pytest.raises(ValueError, match="legacy"):
            fed.build_pipelines_from_spec(spec, device="cpu")
        assert "legacy" in str(exc)
        return
    got = fed.pipeline_fingerprint(fed.build_pipelines_from_spec(spec, device="cpu"),
                                   fed.aggregator_spec(spec))
    assert got == want


def test_live_spec_refuses_what_the_reference_refuses():
    for bad, match in (({"clients": 2, "runtime": {"policy": "fedasync"}}, "runtime"),
                       ({"clients": 2, "quantization": {"fmt": "nf4"}}, "legacy"),
                       ({"clients": 2, "pipeline": {"task_result": ["ef-quantize:nf4"]}},
                        "stateless"),
                       ({"clients": 0}, "at least one client"),
                       ({"clients": 2, "quorum": 1.5}, "quorum"),
                       ({"clients": 2, "straggler_grace_s": 0}, "straggler_grace_s"),
                       ({"clients": 2, "max_reconnects": -1}, "max_reconnects")):
        for mod in (fed, ref_fed):
            with pytest.raises(ValueError, match=match):
                mod.live_spec(bad)
    with pytest.raises(ValueError, match="uplink mode"):
        fed.FederationServer(_spec(), uplink="sideways", device="cpu")
    spec = fed.live_spec(LIVE_SMOKE, clients=2, rounds=1)
    assert (spec["clients"], spec["rounds"]) == (2, 1)
    assert fed.PROTO == ref_fed.PROTO and fed.UPLINK_MODES == ref_fed.UPLINK_MODES


def test_run_live_federation_with_clients_on_threads(live_init):
    """``spawn=False``: ``on_listen`` starts in-process clients once the
    server listens; the summary carries the logs and byte totals, and
    the weights are the port's ``run_job`` on the same fixed updates."""
    spec = {**LIVE_SMOKE, "clients": 2, "rounds": 1}
    started = []

    def on_listen(server):
        clients = []
        for i in range(2):
            c = fed.FederationClient.for_spec(spec, i, server.address, timeout_s=60.0,
                                              device="cpu")
            c.executor.train_fn = testing.fixed_train_fn(live_init, i, 0.05 * (i + 1))
            clients.append(c)
        started.append(_start(clients))

    out = fed.run_live_federation(spec, spawn=False, device="cpu", on_listen=on_listen)
    threads, errors = started[0]
    _join(threads)
    assert not errors
    assert out["client_exit_codes"] == [] and out["restarts"] == 0
    assert [r["clients"] for r in out["round_log"]] == [["site-0", "site-1"]]
    assert len(out["uplink_log"]) == 2 and out["bytes_up"] > 0 and out["bytes_down"] > 0
    jb = port_job.build_job(spec, device="cpu", weights=live_init)
    for i, proxy in enumerate(jb.sim.proxies):
        proxy.executor.train_fn = testing.fixed_train_fn(live_init, i, 0.05 * (i + 1))
    assert fed.weights_bitwise_equal(out["final_weights"], jb.run()["final_weights"])
