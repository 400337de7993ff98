"""Port parity, the live plane under injected chaos: a port
``FederationServer`` on the CPU, ``FederationClient`` threads, and the
afflicted client routed through a port ``ChaosProxy`` — real sockets,
deterministic byte-offset faults, as ``tests/test_chaos.py`` runs the
reference.

The oracle throughout: replaying the recorded per-round contributor sets
sequentially through the same wire pipelines must land on the same bits
as the live run — the port's replay and the reference's replay of the
same numpy executors both, bitwise.

* a stalled uplink past ``straggler_grace_s`` closes the round over the
  survivors (quorum), drains the late stream, and re-invites the
  straggler;
* a blackholed connection reconnects with backoff and rejoins, after
  the poisoned fold restarts;
* a corrupted chunk (crc32) quarantines the client and restarts the
  fold;
* checkpoint / resume reproduces the uninterrupted weights;
* a mute socket is shed at the handshake timeout; ``_reap`` escalates
  terminate to kill against one deadline; ``chaos_federation.json``
  passes ``normalize_spec`` and ``live_spec``.
"""
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.fl import TrainExecutor as RefTrainExecutor  # noqa: E402
from repro.fl.aggregator import build_aggregator as ref_build_aggregator  # noqa: E402
from repro.fl.controller import make_task as ref_make_task  # noqa: E402
from repro.launch import federation as ref_fed  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.core.resilience import ChaosProxy  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402
from repro_torch.fl.aggregator import build_aggregator  # noqa: E402
from repro_torch.fl.controller import make_task  # noqa: E402
from repro_torch.fl.executor import TrainExecutor  # noqa: E402
from repro_torch.launch import federation as fed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHAOS = json.loads((ROOT / "examples" / "jobs" / "chaos_federation.json").read_text())
STACK = ["quantize:blockwise8", "crc32"]
DIM = 4096          # 16 KiB a payload: a fault offset of a few KiB lands mid-uplink
W_TRUE = np.arange(1, DIM + 1, dtype=np.float32) / DIM
INIT = {"w": np.zeros(DIM, np.float32)}


def _train_fn(seed, sleep_s=0.0, dim=DIM):
    w_true = W_TRUE[:dim]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((64, dim)).astype(np.float32)
    y = X @ w_true

    def train_fn(params, rnd):
        if sleep_s:
            time.sleep(sleep_s)
        w = np.asarray(params["w"]).copy()
        for _ in range(2):
            w = w - 0.3 * (X.T @ (X @ w - y) / 64.0)
        return {"w": w}, 64, {}

    return train_fn


def _spec(clients=3, rounds=3, stack=(), **over):
    return {"clients": clients, "rounds": rounds, "chunk_mb": 1,
            "pipeline": {"task_data": list(stack), "task_result": list(stack)}, **over}


def _launch(server, plans, addresses=None, **kwargs):
    """In-process clients on threads (``plans``: name -> (seed, sleep_s));
    ``addresses`` reroutes named clients. Returns (threads, errors)."""
    pipelines = fed.build_pipelines_from_spec(server.spec, device="cpu")
    errors, threads = [], []
    for name, (seed, sleep_s, dim) in plans.items():
        client = fed.FederationClient(
            name=name, executor=TrainExecutor(name, _train_fn(seed, sleep_s, dim)),
            pipelines=pipelines, address=(addresses or {}).get(name, server.address),
            fingerprint=server.fingerprint, timeout_s=60.0, **kwargs)

        def run(c=client):
            try:
                c.run()
            except Exception as exc:  # noqa: BLE001 - surfaced by the test
                errors.append(exc)

        t = threading.Thread(target=run, daemon=True, name=f"chaos-{name}")
        t.start()
        threads.append(t)
    return threads, errors


def _join(threads, timeout=60):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "client thread wedged"


def _replays(spec, plans, rosters, init):
    """The port's and the reference's sequential replay over the
    recorded contributor sets (``reference_run`` with these executors)."""
    out = []
    for mod, msg_cls, kind, task, agg_of, ex_cls, kw in (
            (fed, Message, MessageKind, make_task,
             lambda s: build_aggregator(s, device="cpu"), TrainExecutor, {"device": "cpu"}),
            (ref_fed, RefMessage, RefKind, ref_make_task, ref_build_aggregator,
             RefTrainExecutor, {})):
        live = mod.live_spec(spec)
        chunk = int(live["chunk_mb"] * (1 << 20))
        pipelines = mod.build_pipelines_from_spec(live, **kw)
        executors = {n: ex_cls(n, _train_fn(seed, 0.0, dim))
                     for n, (seed, _, dim) in plans.items()}
        weights = dict(init)
        for rnd, roster in enumerate(rosters):
            agg = agg_of(mod.aggregator_spec(live))
            for name in roster:
                t = task(rnd, weights)
                t.headers.setdefault("client", name)
                t = mod._wire_roundtrip(pipelines["task_data"], t, kind.TASK_DATA, chunk)
                result = executors[name].execute(t)
                mod._wire_roundtrip(pipelines["task_result"],
                                    msg_cls(result.kind, dict(result.payload),
                                            dict(result.headers)),
                                    kind.TASK_RESULT, chunk, sink=agg)
            weights = agg.finish()
        out.append(weights)
    return out


def _assert_replays(live, spec, plans, log, init):
    port_ref, ref_ref = _replays(spec, plans, [r["clients"] for r in log], init)
    assert fed.weights_bitwise_equal(live, port_ref)
    assert fed.weights_bitwise_equal(live, ref_ref)


def _plans(n=3, sleep_s=0.15, dim=DIM, slow=()):
    return {f"site-{i}": (i, sleep_s if (not slow or f"site-{i}" in slow) else 0.0, dim)
            for i in range(n)}


def test_straggler_quorum_round_finishes_with_survivors_bitwise():
    spec = _spec(rounds=6, quorum=0.6, straggler_grace_s=0.6)
    plans = _plans(sleep_s=0.2, slow=("site-0", "site-1"))
    server = fed.FederationServer(spec, join_timeout_s=30, device="cpu").start()
    proxy = ChaosProxy(server.address, {"kind": "stall", "after_bytes": 2000,
                                        "stall_s": 1.2, "direction": "up"}).start()
    try:
        threads, errors = _launch(server, plans, addresses={"site-2": proxy.address})
        live = server.run(dict(INIT))
        _join(threads)
        assert not errors
    finally:
        proxy.close()
        server.close()
    log = server.round_log
    assert log[0]["clients"] == ["site-0", "site-1"] and log[0]["stragglers"] == ["site-2"]
    assert server.faults["stragglers"].get("site-2", 0) >= 1
    assert any("site-2" in r["clients"] for r in log[1:])
    assert "site-2" not in server.faults["lost"]
    assert {"round": 0, "client": "site-2", "granted": True, "items": 0,
            "outcome": "straggler"} in server.uplink_log
    _assert_replays(live, spec, plans, log, INIT)


def test_blackhole_reconnects_with_backoff_and_rejoins_bitwise():
    spec = _spec(rounds=4)
    plans = _plans()
    server = fed.FederationServer(spec, join_timeout_s=30, device="cpu").start()
    proxy = ChaosProxy(server.address, {"kind": "blackhole", "after_bytes": 2000,
                                        "direction": "up"}).start()
    try:
        threads, errors = _launch(server, plans, addresses={"site-2": proxy.address},
                                  max_reconnects=8, backoff_base_s=0.05)
        live = server.run(dict(INIT))
        _join(threads)
        assert not errors
    finally:
        proxy.close()
        server.close()
    log = server.round_log
    assert log[0]["clients"] == ["site-0", "site-1"]
    assert server.restarts >= 1
    assert server.faults["reconnects"].get("site-2", 0) >= 1
    assert "site-2" in log[-1]["clients"]
    _assert_replays(live, spec, plans, log, INIT)


def test_corrupt_chunk_quarantines_client_and_the_fold_restarts():
    spec = _spec(rounds=4, stack=STACK)
    plans = _plans()
    server = fed.FederationServer(spec, join_timeout_s=30, device="cpu").start()
    proxy = ChaosProxy(server.address, {"kind": "corrupt", "after_bytes": 2600,
                                        "direction": "up"}).start()
    try:
        threads, errors = _launch(server, plans, addresses={"site-2": proxy.address},
                                  max_reconnects=8, backoff_base_s=0.05)
        live = server.run(dict(INIT))
        _join(threads)
        assert not errors
    finally:
        proxy.close()
        server.close()
    log = server.round_log
    assert log[0]["clients"] == ["site-0", "site-1"]
    assert "site-2" in server.faults["quarantined"]
    assert server.restarts >= 1 and "site-2" in log[-1]["clients"]
    assert any(e["outcome"] == "quarantined" for e in server.uplink_log)
    _assert_replays(live, spec, plans, log, INIT)


def test_checkpoint_resume_reproduces_uninterrupted_weights_bitwise(tmp_path):
    plans = _plans(sleep_s=0.0, dim=256)
    init = {"w": np.zeros(256, np.float32)}
    full = _spec(rounds=4, stack=STACK)

    def run(spec, **kw):
        server = fed.FederationServer(spec, join_timeout_s=30, device="cpu", **kw).start()
        try:
            threads, errors = _launch(server, plans)
            out = server.run(dict(init))
            _join(threads)
            assert not errors
        finally:
            server.close()
        return out, server

    uninterrupted, _ = run(full)
    ckpt = str(tmp_path / "ckpt")
    run(_spec(rounds=2, stack=STACK), checkpoint_dir=ckpt)
    resumed, second = run(full, checkpoint_dir=ckpt, resume=True)
    assert second.resumed_from == 1
    assert [r["round"] for r in second.round_log] == [0, 1, 2, 3]
    assert fed.weights_bitwise_equal(resumed, uninterrupted)
    _assert_replays(resumed, full, plans, second.round_log, init)
    with pytest.raises(ValueError, match="checkpoint directory"):
        fed.FederationServer(full, resume=True, device="cpu")


def test_mute_connection_is_shed_without_disturbing_the_round():
    spec = _spec(clients=2, rounds=2)
    server = fed.FederationServer(spec, join_timeout_s=30, handshake_timeout_s=0.3,
                                  device="cpu").start()
    try:
        mute = socket.create_connection(server.address)
        threads, errors = _launch(server, _plans(n=2, sleep_s=0.2))
        live = server.run(dict(INIT))
        _join(threads)
        assert not errors
        mute.settimeout(10.0)
        assert mute.recv(1) == b""
        mute.close()
    finally:
        server.close()
    assert server.faults["handshake_timeouts"] == 1
    assert [r["clients"] for r in server.round_log] == [["site-0", "site-1"]] * 2
    assert tuple(live["w"].shape) == (DIM,)


def test_reap_escalates_terminate_then_kill_against_one_deadline():
    quick = subprocess.Popen([sys.executable, "-c", "pass"])
    stuck = subprocess.Popen([
        sys.executable, "-c",
        "import signal, time\n"
        "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        "print('armed', flush=True)\n"
        "time.sleep(60)",
    ], stdout=subprocess.PIPE)
    stuck.stdout.readline()
    t0 = time.monotonic()
    codes = fed._reap([quick, stuck], 0.5)
    wall = time.monotonic() - t0
    stuck.stdout.close()
    assert codes[0] == 0 and codes[1] is not None and codes[1] != 0
    assert quick.poll() is not None and stuck.poll() is not None
    assert wall < 15.0
    assert fed._reap([], 1.0) == []


def test_chaos_federation_spec_is_accepted():
    spec = port_job.normalize_spec(CHAOS)
    assert spec["quorum"] == 0.5 and set(spec["chaos"]) == {"site-1", "site-2", "site-3"}
    live = fed.live_spec(CHAOS)
    assert live == ref_fed.live_spec(CHAOS)
    with pytest.raises(NotImplementedError, match="kernel_backend"):
        port_job.normalize_spec({**CHAOS, "kernel_backend": "ref"})
