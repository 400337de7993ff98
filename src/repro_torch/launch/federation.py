"""Real multi-process federation over TCP — the live deployment plane.

Mirror of ``src/repro/launch/federation.py``: the same protocol, byte
for byte, so a port client completes a handshake with a reference
server and the reverse (equal stage registries give equal pipeline
fingerprints). Every entry point takes a ``device``: the server's
pipelines, folds and checkpoints and each client's decode, training and
quantize run there — on the card unless the caller asks for the CPU
(``--device cpu``; without CUDA the default raises). Kernels launch on
the default stream from whichever thread encodes, decodes or folds, and
every segment that reaches a socket is host memory.

The simulator proves the paper's quantization + streaming claims on a
simulated clock; this module proves them on a real one. One server
process opens a :class:`~repro_torch.core.streaming.TCPServer` accept loop,
``N`` client subprocesses (``python -m repro_torch.launch.federation
--client-index i --connect host:port``) connect, and real wall-clock
rounds run over the exact wire format, stage pipelines, and streaming
aggregators the simulator uses — driven by the *same* declarative job
spec ``run_job`` takes.

Equivalence guarantee
    With the default ``ordered`` uplink, the server grants uplinks in
    roster order and folds each client's decoded items into one live
    aggregator (``WireDecoder(sink=...)`` — O(item) server memory, never
    K models), executing **identical arithmetic in identical order** to
    the sequential simulator. Deterministic data partitioning + seeds
    make the client subprocesses compute the same local updates, so the
    final weights are **bitwise-equal** to ``run_job`` on the same spec
    (``--verify-sim`` asserts this). ``--uplink concurrent`` folds all
    uplinks at once from per-connection threads — maximum throughput,
    order-free arithmetic, so equality weakens to numerical closeness.

Protocol (PROTO 1)
    JSON control frames and raw chunk streams interleave on one socket
    (:class:`~repro_torch.core.streaming.Connection`). A client opens with
    ``hello`` (name, round epoch, pipeline fingerprint); the server
    answers ``welcome`` or ``reject`` — a mismatched stage stack or a
    stale epoch fails fast at the handshake instead of corrupting a
    fold. Rounds then alternate ``task`` + downlink stream and ``grant``
    / ``result`` + uplink stream, ending with ``done``.

Crash/rejoin semantics
    A client dying mid-uplink must not register phantom weight: its
    ``begin`` already counted sample weight and its partial items are in
    the running sums, so the server discards the poisoned fold, rebuilds
    the aggregator, and re-grants the surviving roster in order
    (clients cache the round's result and re-encode on each grant;
    stateless pipelines make the re-encode deterministic). A crashed
    client may reconnect with the server's *current* round epoch and
    participates from the next downlink.

Fault tolerance
    With ``"quorum"`` set (e.g. ``{"quorum": 0.75,
    "straggler_grace_s": 30}``) a round no longer waits
    ``round_timeout_s`` on its slowest client: every uplink gets
    ``straggler_grace_s``; a client that exceeds it is marked a
    straggler, its late stream is drained and discarded on a background
    thread (the timeout-safe reader resumes mid-frame), and the round
    finishes over the contributors the server has — the streaming
    aggregators make partial folds natural, the fold just ``finish()``es
    early. Drained stragglers are re-invited next round. If the fold is
    still below quorum after the roster is exhausted, the server waits
    for drains to complete and re-grants (the client's cached round
    result is still valid), and only gives up when no straggler remains.
    ``FederationClient`` survives transient connection loss with capped
    exponential backoff + jitter (``max_reconnects`` budget); a decode /
    integrity failure (e.g. a corrupted chunk caught by crc32)
    quarantines the *client* and restarts the fold instead of killing
    the server. With a checkpoint directory configured the server
    atomically persists round epoch + global weights + roster after
    every round, and ``--resume`` restarts at round k+1 with
    bitwise-identical weights. ``ChaosProxy``
    (:mod:`repro_torch.core.resilience`) injects seeded stall / blackhole /
    corrupt / throttle faults between real sockets to test all of it;
    ``reference_run`` replays the recorded per-round contributor sets
    sequentially and must match the live weights bitwise
    (``--verify-chaos``).

Launch accounting
    ``uplink_log`` records every grant: round, client, outcome and the
    payload items that reached the fold. On the card each grant of a
    blockwise8 uplink costs the client one fused quantize group (B1), and
    each folded item costs the server one fold (B3, ``quantized-fedavg``)
    or one dequantize (B2, dense ``fedavg``), so the launches a chaotic
    run implies follow from this log, re-grants and restarted folds
    included (``repro_torch.testing.live_launches``).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import random
import socket
import subprocess
import sys
import tempfile
import threading
import time
from struct import error as struct_error
from collections.abc import Callable
from typing import Any, Mapping, Optional

import torch

from repro_torch.checkpoint import latest_server_state, save_server_state
from repro_torch.core import streaming as sm
from repro_torch.core.messages import Message, MessageKind
from repro_torch.core.pipeline import META_ITEM, WirePipeline, registered_stages
from repro_torch.core.resilience import ChaosProxy
from repro_torch.fl.aggregator import build_aggregator
from repro_torch.fl.controller import make_task
from repro_torch.fl.job import (
    aggregator_spec,
    build_client_executor,
    build_pipelines_from_spec,
    initial_weights,
    normalize_spec,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import disable_tf32, resolve_device
from repro_torch.utils.trees import as_numpy

PROTO = 1

#: uplink scheduling modes: "ordered" serializes grants in roster order
#: (one live fold, bitwise sim-equivalent); "concurrent" folds every
#: uplink at once from per-connection threads (throughput mode)
UPLINK_MODES = ("ordered", "concurrent")


def pipeline_fingerprint(pipelines: Mapping[str, WirePipeline],
                         agg_spec: Any) -> str:
    """Capability fingerprint exchanged at the handshake.

    Hashes everything that must agree for a fold to be meaningful: the
    protocol revision, each hop's stage stack and decode mode, the
    stage registry (a client with extra/missing registered stages could
    decode a task differently), and the aggregator selection. Two
    processes with equal fingerprints provably run the same wire stack.
    """
    desc = {
        "proto": PROTO,
        "stages": {d: [s.name for s in pl.stages]
                   for d, pl in sorted(pipelines.items())},
        "decode_values": {d: bool(pl.decode_values)
                          for d, pl in sorted(pipelines.items())},
        "registry": list(registered_stages()),
        "aggregator": agg_spec,
    }
    return hashlib.sha256(
        json.dumps(desc, sort_keys=True).encode()
    ).hexdigest()[:16]


def live_spec(spec: Mapping[str, Any], clients: Optional[int] = None,
              rounds: Optional[int] = None) -> dict[str, Any]:
    """Normalize + validate a job spec for live deployment.

    The live plane runs real processes on a real clock, so the pieces of
    the spec surface that only make sense inside the simulator are
    rejected up front: the ``runtime`` scenario block (simulated
    networks/availability), the legacy whole-message filter keys, and
    stateful pipelines (crash recovery re-encodes a cached result, which
    must be deterministic — error feedback / DP noise streams are not).

    The pipelines are built on the CPU only to check them; the port
    refuses ``"kernel_backend"`` (it dispatches by device).
    """
    out = normalize_spec(dict(spec))
    if clients is not None:
        out["clients"] = int(clients)
    if rounds is not None:
        out["rounds"] = int(rounds)
    if out.get("runtime"):
        raise ValueError(
            'the "runtime" block configures the *simulated* scenario engine '
            "(virtual networks, availability, async policies); the live plane "
            "runs real clients on a real clock — remove it from live specs"
        )
    if out.get("quantization") or out.get("dp_sigma"):
        raise ValueError(
            'live deployment requires the streaming "pipeline" form; the '
            'legacy "quantization"/"dp_sigma" filter keys are not supported'
        )
    if int(out["clients"]) < 1:
        raise ValueError(f'need at least one client, got {out["clients"]}')
    q = out.get("quorum")
    if q is not None and not 0.0 < float(q) <= 1.0:
        raise ValueError(f'"quorum" must be a fraction in (0, 1], got {q!r}')
    if float(out.get("straggler_grace_s") or 0.0) <= 0.0:
        raise ValueError(
            f'"straggler_grace_s" must be positive, got '
            f'{out.get("straggler_grace_s")!r}')
    if int(out.get("max_reconnects") or 0) < 0:
        raise ValueError(
            f'"max_reconnects" must be >= 0, got {out.get("max_reconnects")!r}')
    pipelines = build_pipelines_from_spec(out, device="cpu")
    for direction, pl in pipelines.items():
        if pl.stateful:
            stateful = [s.name for s in pl.stages if s.stateful]
            raise ValueError(
                f"stateful stage(s) {stateful} in {direction!r}: live crash "
                "recovery re-encodes cached results, which requires "
                "deterministic (stateless) pipelines"
            )
    return out


def weights_bitwise_equal(a: Mapping[str, Any], b: Mapping[str, Any]) -> bool:
    """True iff two flat state dicts (tensors on any device, or numpy
    arrays) are bitwise-identical: same names, shapes, dtypes and bytes."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = as_numpy(a[k]), as_numpy(b[k])
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.tobytes() != y.tobytes():
            return False
    return True


class _ClientLost(Exception):
    """One client's connection failed mid-round (carries the name).

    ``poisoned`` says whether any of its items already reached the
    running aggregation (the fold must then restart); ``quarantine``
    marks integrity/decode failures — the *client* sent garbage, the
    link is irrelevant, so the failure is recorded as a quarantine
    rather than a transport loss."""

    def __init__(self, name: str, why: str, *, poisoned: bool = True,
                 quarantine: bool = False) -> None:
        super().__init__(f"{name}: {why}")
        self.client = name
        self.why = why
        self.poisoned = poisoned
        self.quarantine = quarantine


class _Straggled(Exception):
    """A client exceeded ``straggler_grace_s`` mid-uplink (quorum mode).

    ``stage`` is where the grace expired (``"result"``: the grant went
    out but no result control frame came back; ``"stream"``: mid chunk
    stream) — the drain thread needs it to know what is still inbound.
    ``poisoned`` mirrors :class:`_ClientLost`."""

    def __init__(self, name: str, stage: str, *, poisoned: bool) -> None:
        super().__init__(f"{name}: straggled at {stage}")
        self.client = name
        self.stage = stage
        self.poisoned = poisoned


class _StaleEpoch(Exception):
    """Handshake reject carrying the server's current round — the
    client retries immediately at the right epoch (a redirect, not a
    fault)."""

    def __init__(self, round_: int) -> None:
        super().__init__(f"server is at round {round_}")
        self.round = round_


class FederationServer:
    """The live server: accept loop, handshakes, real wall-clock rounds.

    Owns a :class:`~repro_torch.core.streaming.TCPServer`; every accepted
    connection handshakes on its own thread, then round logic drives all
    traffic — per-client downlink sender threads, and either ordered
    grant-serialized uplinks (default, sim-bitwise) or concurrent
    per-connection fold threads. Server memory stays O(item): each uplink
    decodes straight into the shared streaming aggregator via
    ``WireDecoder(sink=...)`` — no client payload dict ever materializes.
    Pipelines, folds and checkpoints run on ``device``.
    """

    def __init__(self, spec: Mapping[str, Any], host: str = "127.0.0.1",
                 port: int = 0, uplink: str = "ordered",
                 join_timeout_s: float = 60.0,
                 round_timeout_s: float = 600.0,
                 handshake_timeout_s: float = 10.0,
                 checkpoint_dir: Optional[str] = None,
                 resume: bool = False, device: Any = None) -> None:
        if uplink not in UPLINK_MODES:
            raise ValueError(f"uplink mode {uplink!r}; valid: {UPLINK_MODES}")
        self.spec = live_spec(spec)
        self.device = resolve_device(device)
        self.n_clients = int(self.spec["clients"])
        self.rounds = int(self.spec["rounds"])
        self.chunk_size = int(self.spec["chunk_mb"] * (1 << 20))
        self.pipelines = build_pipelines_from_spec(self.spec, device=self.device)
        self.agg_spec = aggregator_spec(self.spec)
        self.fingerprint = pipeline_fingerprint(self.pipelines, self.agg_spec)
        self.uplink = uplink
        self.join_timeout_s = join_timeout_s
        self.round_timeout_s = round_timeout_s
        self.handshake_timeout_s = handshake_timeout_s
        q = self.spec.get("quorum")
        self.quorum = None if q is None else float(q)
        self.straggler_grace_s = float(self.spec["straggler_grace_s"])
        self.checkpoint_dir = (checkpoint_dir if checkpoint_dir is not None
                               else self.spec.get("checkpoint"))
        self._server = sm.TCPServer(host, port)
        self.address = self._server.address
        self._lock = threading.Lock()
        self._join_cv = threading.Condition(self._lock)
        # drain bookkeeping shares the lock: a straggler whose late
        # uplink is still being discarded must not be re-granted or
        # re-rostered until its socket is clean again
        self._drain_cv = threading.Condition(self._lock)
        self._conns: dict[str, sm.Connection] = {}
        self._lost: set[str] = set()
        self._draining: dict[str, bool] = {}
        self._tasked: set[str] = set()
        self._round = 0
        self._roster = tuple(f"site-{i}" for i in range(self.n_clients))
        self.round_log: list[dict[str, Any]] = []
        self.uplink_log: list[dict[str, Any]] = []
        self.bytes_down = 0
        self.bytes_up = 0
        self.restarts = 0
        self.rejects: list[dict[str, str]] = []
        self.faults: dict[str, Any] = {
            "stragglers": {}, "reconnects": {}, "quarantined": {},
            "lost": {}, "handshake_timeouts": 0,
        }
        self.metrics = obs_metrics.MetricsRegistry()
        # adaptive encode-ahead shared by every downlink sender: grows
        # from DEFAULT_ENCODE_AHEAD when the wire observes encode stalls
        # (wire bytes are bitwise-identical at any depth)
        self.encode_ahead = sm.AdaptiveEncodeAhead()
        self.resumed_from: Optional[int] = None
        self._resume_weights: Optional[dict[str, Any]] = None
        if resume:
            if not self.checkpoint_dir:
                raise ValueError(
                    "resume=True needs a checkpoint directory (the "
                    '"checkpoint" spec key or --checkpoint-dir)')
            state = latest_server_state(self.checkpoint_dir, self.device)
            if state is not None:
                # epoch set before the accept loop starts, so handshakes
                # see the restart round, not 0
                self._round = int(state["round"]) + 1
                self._resume_weights = state["weights"]
                self.resumed_from = int(state["round"])
                self.round_log = list(state["meta"].get("round_log", []))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FederationServer":
        self._server.serve(self._on_connection)
        return self

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
        self._server.close()

    @property
    def current_round(self) -> int:
        with self._lock:
            return self._round

    # -- handshake ----------------------------------------------------------
    def _reject(self, conn: sm.Connection, reason: str,
                code: str = "error", **extra: Any) -> None:
        with self._lock:
            self.rejects.append({"peer": str(conn.peer), "reason": reason,
                                 "code": code})
        with contextlib.suppress(OSError):
            conn.send_ctrl({"type": "reject", "reason": reason,
                            "code": code, **extra})
        conn.close()

    def _on_connection(self, conn: sm.Connection) -> None:
        # a connected-but-mute socket is shed after handshake_timeout_s,
        # not round_timeout_s — it must never hold an accept thread (or a
        # roster slot) while a round is in flight
        conn.settimeout(self.handshake_timeout_s)
        tr = obs_trace.ACTIVE
        span = (tr.span("fed.handshake", "fed", peer=str(conn.peer))
                if tr else contextlib.nullcontext())
        with span:
            try:
                hello = conn.recv_ctrl()
            except TimeoutError:
                with self._lock:
                    self.faults["handshake_timeouts"] += 1
                self.metrics.counter("fed.handshake_timeout").inc()
                conn.close()
                return
            except (OSError, sm.ProtocolError, ConnectionError):
                conn.close()
                return
            if hello.get("type") != "hello":
                return self._reject(
                    conn, f'expected "hello", got {hello.get("type")!r}',
                    code="bad-hello")
            if hello.get("proto") != PROTO:
                return self._reject(
                    conn, f"protocol revision {hello.get('proto')} != {PROTO}",
                    code="proto")
            name = str(hello.get("client", ""))
            if name not in self._roster:
                return self._reject(
                    conn, f"unknown client {name!r}; roster is "
                          f"site-0..site-{self.n_clients - 1}",
                    code="unknown-client")
            if hello.get("fingerprint") != self.fingerprint:
                return self._reject(
                    conn,
                    f"pipeline fingerprint mismatch: server runs "
                    f"{self.fingerprint}, client {hello.get('fingerprint')} — "
                    "stage stacks or aggregator differ; refusing to fold",
                    code="fingerprint",
                )
            with self._lock:
                epoch = int(hello.get("epoch", 0))
                cur = self._round
                stale = epoch != cur
                dup = not stale and name in self._conns
                rejoined = False
                if not stale and not dup:
                    # welcome must be on the wire before the round loop
                    # can see this client (notify below) — otherwise the
                    # first task frame could beat the welcome
                    conn.settimeout(self.round_timeout_s)
                    try:
                        conn.send_ctrl({"type": "welcome", "round": cur,
                                        "rounds": self.rounds,
                                        "clients": self.n_clients,
                                        "uplink": self.uplink})
                    except OSError:
                        conn.close()
                        return
                    self._conns[name] = conn
                    rejoined = name in self._lost
                    self._lost.discard(name)
                    self._join_cv.notify_all()
            if stale:
                # structured redirect: the client retries immediately at
                # the round the server is actually on (resume / rejoin)
                return self._reject(
                    conn,
                    f"stale round epoch {epoch}: server is at round {cur}; "
                    f"reconnect with the current epoch",
                    code="stale-epoch", round=cur)
            if dup:
                return self._reject(
                    conn, f"duplicate client {name!r}: already connected",
                    code="duplicate")
            attempts = int(hello.get("reconnects", 0))
            if rejoined or attempts:
                with self._lock:
                    self.faults["reconnects"][name] = (
                        self.faults["reconnects"].get(name, 0) + 1)
                self.metrics.counter("fed.reconnect", client=name).inc()
                if tr:
                    with tr.span("fed.reconnect", "fed", client=name,
                                 round=cur, attempts=attempts):
                        pass

    def wait_for_clients(self, n: Optional[int] = None) -> None:
        """Block until ``n`` (default: the full roster) clients joined."""
        want = self.n_clients if n is None else n
        deadline = time.monotonic() + self.join_timeout_s
        with self._join_cv:
            while len(self._conns) < want:
                left = deadline - time.monotonic()
                if left <= 0 or not self._join_cv.wait(timeout=left):
                    missing = [c for c in self._roster if c not in self._conns]
                    raise TimeoutError(
                        f"{len(self._conns)}/{want} clients joined within "
                        f"{self.join_timeout_s}s; missing {missing}"
                    )

    # -- client failure -----------------------------------------------------
    def _drop(self, name: str, why: str, quarantine: bool = False) -> None:
        with self._drain_cv:
            conn = self._conns.pop(name, None)
            self._lost.add(name)
            self._tasked.discard(name)
            self._draining.pop(name, None)
            self.faults["lost"][name] = why
            if quarantine:
                self.faults["quarantined"][name] = why
            self._drain_cv.notify_all()
        if conn is not None:
            conn.close()

    def _lose(self, exc: _ClientLost) -> None:
        self._drop(exc.client, exc.why, quarantine=exc.quarantine)
        kind = "fed.quarantine" if exc.quarantine else "fed.client_lost"
        self.metrics.counter(kind, client=exc.client).inc()

    # -- stragglers (quorum mode) -------------------------------------------
    def _mark_straggler(self, exc: _Straggled, rnd: int) -> None:
        """Record a straggler and start draining its late uplink.

        The connection stays open: the timeout-safe reader kept every
        byte received so far, so a background thread resumes exactly
        mid-frame, reads the rest of the late stream, and discards it —
        the closed round's data never touches a fold, and the socket is
        clean for the next round's re-invite."""
        name = exc.client
        with self._lock:
            self.faults["stragglers"][name] = (
                self.faults["stragglers"].get(name, 0) + 1)
            conn = self._conns.get(name)
            self._draining[name] = True
        self.metrics.counter("fed.straggler", client=name).inc()
        tr = obs_trace.ACTIVE
        if tr:
            with tr.span("fed.straggler", "fed", client=name, round=rnd,
                         stage=exc.stage):
                pass
        threading.Thread(
            target=self._drain_straggler, args=(name, conn, exc.stage),
            daemon=True, name=f"fed-drain-{name}",
        ).start()

    def _drain_straggler(self, name: str, conn: Optional[sm.Connection],
                         stage: str) -> None:
        try:
            if conn is None:
                raise ConnectionError("connection gone before drain")
            if stage == "result":
                # the grant went out but the result header hadn't
                # arrived yet — it (and the stream) are still inbound
                ctrl = conn.recv_ctrl()
                if ctrl.get("type") != "result":
                    raise sm.ProtocolError(
                        f"draining {name}: expected a late result frame, "
                        f"got {ctrl}")
            conn.recv_stream(lambda chunk: None)  # discard, don't decode
        except (TimeoutError, OSError, ConnectionError, sm.ProtocolError,
                ValueError, struct_error) as exc:
            self._drop(name, f"straggler drain failed: {exc}")
        finally:
            with self._drain_cv:
                self._draining.pop(name, None)
                self._drain_cv.notify_all()

    def _quorum_need(self, roster: list[str]) -> Optional[int]:
        if self.quorum is None:
            return None
        return max(1, math.ceil(self.quorum * len(roster)))

    def _await_rejoin(self, roster: list[str],
                      contributed: list[str]) -> list[str]:
        """Below quorum with no one left to grant: wait for a draining
        straggler to come clean (its cached result for this round is
        still grantable). Returns newly grantable names, or ``[]`` when
        no drain is pending / the wait timed out — quorum unreachable."""
        deadline = time.monotonic() + self.round_timeout_s
        done = set(contributed)
        with self._drain_cv:
            while True:
                ready = [n for n in roster
                         if n in self._conns and n in self._tasked
                         and not self._draining.get(n) and n not in done]
                if ready:
                    return ready
                if not any(self._draining.get(n) for n in roster):
                    return []
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                self._drain_cv.wait(timeout=left)

    # -- downlink -----------------------------------------------------------
    def _downlink_one(self, name: str, rnd: int,
                      weights: Mapping[str, Any]) -> None:
        conn = self._conns.get(name)
        if conn is None:
            raise _ClientLost(name, "not connected at downlink")
        task = make_task(rnd, weights)
        # destination in the headers, same as the simulator's proxy, so
        # egress stages can be link/client-aware
        task.headers.setdefault("client", name)
        pipeline = self.pipelines["task_data"]
        try:
            # in quorum mode a stalled downlink only gets the straggler
            # grace: a partially-written task stream makes the socket
            # unusable anyway, so the client is dropped (it reconnects)
            # rather than allowed to stall the broadcast barrier
            if self.quorum is not None:
                conn.settimeout(self.straggler_grace_s)
            try:
                conn.send_ctrl({"type": "task", "round": rnd})
                driver = sm.ConnectionDriver(conn)
                msg, ctx = pipeline.begin_encode(task)
                # encode-ahead: this is a real socket, so while item k's
                # segments sit in sendmsg the worker encodes item k+1
                # (bitwise-identical wire bytes — see iter_encode_ahead)
                sm.ContainerStreamer(
                    driver, self.chunk_size, prefetch=self.encode_ahead
                ).send_items(
                    pipeline.iter_encode_views(msg, ctx), pipeline.n_items(msg)
                )
            finally:
                if self.quorum is not None:
                    with contextlib.suppress(OSError):
                        conn.settimeout(self.round_timeout_s)
        except TimeoutError as exc:
            raise _ClientLost(
                name, f"downlink stalled past the straggler grace: {exc}",
                poisoned=False) from exc
        except (OSError, ConnectionError) as exc:
            raise _ClientLost(name, f"downlink failed: {exc}",
                              poisoned=False) from exc
        with self._lock:
            self.bytes_down += driver.bytes_sent

    def _downlink(self, roster: list[str], rnd: int,
                  weights: Mapping[str, Any]) -> list[str]:
        """Broadcast the round's task to ``roster`` from parallel sender
        threads; returns the clients that actually received it."""
        tr = obs_trace.ACTIVE
        failed: dict[str, str] = {}

        def send(name: str) -> None:
            span = (tr.span("fed.downlink", "fed", client=name, round=rnd)
                    if tr else contextlib.nullcontext())
            try:
                with span:
                    self._downlink_one(name, rnd, weights)
            except _ClientLost as exc:
                failed[name] = exc.why

        threads = [threading.Thread(target=send, args=(n,), daemon=True,
                                    name=f"fed-downlink-{n}") for n in roster]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name, why in failed.items():
            self._drop(name, why)
        return [n for n in roster if n not in failed]

    # -- uplink -------------------------------------------------------------
    def _uplink_one(self, name: str, rnd: int, agg: Any) -> dict[str, Any]:
        """Grant ``name``'s uplink and fold its stream into ``agg``.

        Failure taxonomy: a transport error raises :class:`_ClientLost`
        (``quarantine=False``); framed garbage — integrity (crc32),
        decode, or protocol violations — raises :class:`_ClientLost`
        with ``quarantine=True`` (the client is bad, not the link); in
        quorum mode a grace timeout after the grant raises
        :class:`_Straggled` instead. All three carry ``poisoned``: True
        iff any decoded item already reached ``agg`` (its ``begin``
        sample weight or partial items are in the running sums, so the
        caller must discard the fold and restart).
        """
        conn = self._conns.get(name)
        if conn is None:
            raise _ClientLost(name, "not connected at uplink",
                              poisoned=False)
        grace = self.straggler_grace_s if self.quorum is not None else None
        tr = obs_trace.ACTIVE
        span = (tr.span("fed.uplink", "fed", client=name, round=rnd)
                if tr else contextlib.nullcontext())
        stage = "grant"
        folded = [0]
        items = [0]      # payload items that reached the fold (uplink_log)
        outcome = "lost"
        try:
            with span as sp:
                try:
                    if grace is not None:
                        conn.settimeout(grace)
                    try:
                        conn.send_ctrl({"type": "grant", "round": rnd})
                        stage = "result"
                        ctrl = conn.recv_ctrl()
                        if ctrl.get("type") != "result" or ctrl.get("round") != rnd:
                            raise _ClientLost(
                                name, f"expected result/round={rnd}, got {ctrl}",
                                poisoned=False, quarantine=True)
                        stage = "stream"
                        decoder = self.pipelines["task_result"].decoder(sink=agg)

                        def consume(iname: str, value: Any) -> None:
                            folded[0] += 1  # poison marker: agg was touched
                            items[0] += iname != META_ITEM
                            decoder.on_item(iname, value)

                        recv = sm.ContainerReceiver(consume=consume,
                                                    decode_item=decoder.decode_item,
                                                    device=decoder.ctx.device)
                        nbytes = conn.recv_stream(recv.on_chunk)
                        result = decoder.finish(MessageKind.TASK_RESULT)
                    finally:
                        if grace is not None:
                            with contextlib.suppress(OSError):
                                conn.settimeout(self.round_timeout_s)
                except _ClientLost:
                    raise
                except TimeoutError as exc:
                    if grace is None or stage == "grant":
                        raise _ClientLost(
                            name, f"uplink timed out at {stage}: {exc}",
                            poisoned=folded[0] > 0) from exc
                    raise _Straggled(name, stage,
                                     poisoned=folded[0] > 0) from exc
                except (OSError, ConnectionError) as exc:
                    raise _ClientLost(name, f"uplink failed: {exc}",
                                      poisoned=folded[0] > 0) from exc
                except (sm.ProtocolError, ValueError, KeyError,
                        struct_error) as exc:
                    # includes WireIntegrityError from crc32: corrupted
                    # payload bytes quarantine the sender, never the server
                    raise _ClientLost(name, f"uplink decode failed: {exc}",
                                      poisoned=folded[0] > 0,
                                      quarantine=True) from exc
                if sp is not None:
                    sp.args["nbytes"] = nbytes
            outcome = "folded"
        except _Straggled:
            outcome = "straggler"
            raise
        except _ClientLost as exc:
            if exc.quarantine:
                outcome = "quarantined"
            raise
        finally:
            with self._lock:
                self.uplink_log.append({"round": rnd, "client": name,
                                        "granted": stage != "grant",
                                        "items": items[0], "outcome": outcome})
        with self._lock:
            self.bytes_up += nbytes
        return dict(result.headers)

    def _gather(self, roster: list[str],
                rnd: int) -> tuple[dict[str, Any], list[str]]:
        """One round's aggregation with crash recovery; returns the new
        global weights and the clients whose contribution is in them, in
        fold order.

        Without a quorum this is all-surviving-clients-or-restart: any
        loss discards the fold (partial items / ``begin`` weight may be
        in the running sums) and refolds over the survivors. With
        ``"quorum"`` set, each uplink gets ``straggler_grace_s``; a
        clean (un-poisoned) straggle just skips that client — the
        streaming aggregator finishes early over the contributors it
        has — while a poisoned one restarts the fold. If the roster is
        exhausted below quorum, the server waits for straggler drains to
        complete and re-grants them (clients cache the round's result),
        giving up only when no straggler remains to wait for.
        """
        need_fixed = self._quorum_need(roster)
        while True:  # one iteration per fold attempt
            with self._lock:
                queue = [n for n in roster
                         if n in self._conns and n in self._tasked
                         and not self._draining.get(n)]
            need = len(queue) if need_fixed is None else need_fixed
            if need_fixed is None and not queue:
                raise RuntimeError(
                    f"round {rnd}: every client was lost; nothing to aggregate"
                )
            # a fresh aggregator per attempt: a poisoned fold's device
            # sums are discarded, never reused
            agg = build_aggregator(self.agg_spec, device=self.device)
            contributed: list[str] = []
            poisoned = False

            if self.uplink == "concurrent":
                failures: dict[str, Exception] = {}

                def fold(name: str) -> None:
                    try:
                        self._uplink_one(name, rnd, agg)
                        contributed.append(name)
                    except (_Straggled, _ClientLost) as exc:
                        failures[name] = exc

                threads = [threading.Thread(target=fold, args=(n,),
                                            daemon=True,
                                            name=f"fed-uplink-{n}")
                           for n in queue]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                for exc in failures.values():
                    if isinstance(exc, _Straggled):
                        self._mark_straggler(exc, rnd)
                    else:
                        self._lose(exc)
                    # concurrent folds interleave arbitrarily: any
                    # failure taints the shared sums
                    poisoned = True
            else:
                while queue or len(contributed) < need:
                    if not queue:
                        ready = self._await_rejoin(roster, contributed)
                        if not ready:
                            break  # quorum unreachable — raise below
                        queue.extend(ready)
                        continue
                    name = queue.pop(0)
                    try:
                        self._uplink_one(name, rnd, agg)
                        contributed.append(name)
                    except _Straggled as exc:
                        self._mark_straggler(exc, rnd)
                        if exc.poisoned:
                            poisoned = True
                            break
                    except _ClientLost as exc:
                        self._lose(exc)
                        # without a quorum any loss restarts (the old
                        # all-or-nothing contract); with one, a clean
                        # loss just shrinks the contributor set
                        if exc.poisoned or need_fixed is None:
                            poisoned = True
                            break

            if poisoned:
                with self._lock:
                    self.restarts += 1
                continue
            if len(contributed) >= need:
                return agg.finish(), contributed
            raise RuntimeError(
                f"round {rnd}: quorum unreachable — "
                f"{len(contributed)}/{need} of {len(roster)} clients"
            )

    # -- the round loop -----------------------------------------------------
    def run(self, init_weights: Mapping[str, Any]) -> dict[str, Any]:
        """Run all rounds; returns the final global weights."""
        tracer = None
        trace_spec = self.spec.get("trace")
        if trace_spec:
            # on the card, spans synchronise at their edges so their wall
            # times include the kernels they launched
            tracer = obs_trace.Tracer(
                sync=torch.cuda.synchronize if self.device.type == "cuda" else None)
        ctx = (obs_trace.activate(tracer) if tracer is not None
               else contextlib.nullcontext())
        with ctx, obs_metrics.activate(self.metrics):
            with self._lock:
                start = self._round  # > 0 when resuming
                resume_weights = self._resume_weights
                self._resume_weights = None
            weights = (dict(resume_weights) if resume_weights is not None
                       else dict(init_weights))
            self.wait_for_clients()
            for rnd in range(start, self.rounds):
                with self._lock:
                    self._round = rnd
                    # stragglers still being drained sit this round out;
                    # they rejoin the roster once their socket is clean
                    roster = [n for n in self._roster
                              if n in self._conns
                              and not self._draining.get(n)]
                if not roster:
                    raise RuntimeError(f"round {rnd}: no clients connected")
                tr = obs_trace.ACTIVE
                span = (tr.span("fed.round", "round", round=rnd,
                                clients=len(roster))
                        if tr else contextlib.nullcontext())
                t0 = time.monotonic()
                with span:
                    active = self._downlink(roster, rnd, weights)
                    with self._lock:
                        self._tasked = set(active)
                    weights, contributed = self._gather(active, rnd)
                self.round_log.append({
                    "round": rnd,
                    "clients": contributed,
                    "stragglers": [n for n in active if n not in contributed],
                    "wall_s": round(time.monotonic() - t0, 6),
                })
                if self.checkpoint_dir:
                    # atomic persist *before* the epoch advances: a crash
                    # between the two resumes at this round's successor
                    # with exactly this round's weights
                    save_server_state(
                        self.checkpoint_dir, rnd, weights,
                        meta={"roster": roster, "contributors": contributed,
                              "round_log": self.round_log})
                with self._lock:
                    self._round = rnd + 1
            with self._lock:
                conns = list(self._conns.values())
            for conn in conns:
                with contextlib.suppress(OSError):
                    conn.send_ctrl({"type": "done"})
        if tracer is not None and isinstance(trace_spec, str):
            tracer.write(trace_spec)
        return weights


class FederationClient:
    """One live client: connect, handshake, then react to server control.

    ``run()`` loops on control frames: ``task`` (receive + decode the
    downlink stream, execute the local computation, cache the result),
    ``grant`` (re-encode the cached round result and stream it up —
    idempotent, so a server-side fold restart can simply grant again),
    ``done`` (exit). A ``reject`` at the handshake raises with the
    server's reason. The executor and pipelines carry the device.
    """

    def __init__(self, name: str, executor: Any,
                 pipelines: Mapping[str, WirePipeline],
                 address: tuple[str, int], fingerprint: str,
                 epoch: int = 0, chunk_size: int = 1 << 20,
                 timeout_s: Optional[float] = None,
                 max_reconnects: int = 0,
                 backoff_base_s: float = 0.25,
                 backoff_cap_s: float = 10.0) -> None:
        self.name = name
        self.executor = executor
        self.pipelines = dict(pipelines)
        self.address = tuple(address)
        self.fingerprint = fingerprint
        self.epoch = epoch
        self.chunk_size = chunk_size
        self.timeout_s = timeout_s
        self.max_reconnects = int(max_reconnects)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.rounds_done = 0
        self.faults = {"reconnects": 0}
        # per-process adaptive uplink encode-ahead (bitwise-stable depth)
        self.encode_ahead = sm.AdaptiveEncodeAhead()

    @classmethod
    def for_spec(cls, spec: Mapping[str, Any], index: int,
                 address: tuple[str, int], epoch: int = 0,
                 timeout_s: Optional[float] = None,
                 device: Any = None) -> "FederationClient":
        """Build the client exactly as the spec describes it — same
        executor/pipeline construction path as the simulator, which is
        what makes live weights bitwise-comparable to ``run_job``. On
        the card TF32 goes off, as ``build_job`` turns it off."""
        spec = live_spec(spec)
        device = resolve_device(device)
        if device.type == "cuda":
            disable_tf32()
        pipelines = build_pipelines_from_spec(spec, device=device)
        return cls(
            name=f"site-{index}",
            executor=build_client_executor(spec, index, device=device),
            pipelines=pipelines,
            address=address,
            fingerprint=pipeline_fingerprint(pipelines, aggregator_spec(spec)),
            epoch=epoch,
            chunk_size=int(spec["chunk_mb"] * (1 << 20)),
            timeout_s=timeout_s,
            max_reconnects=int(spec.get("max_reconnects") or 0),
        )

    def run(self) -> int:
        """Participate until the server says ``done``; returns the number
        of rounds this client's results were (last) granted for.

        Transient transport failures (connection refused/reset, socket
        timeout, torn frames) reconnect with capped exponential backoff
        plus deterministic jitter, up to ``max_reconnects`` attempts per
        run; a structured ``stale-epoch`` reject is a redirect — retry
        immediately at the server's round. Either way the client rejoins
        at the server's current epoch and participates from the next
        downlink (the executor is a pure function of (params, round), so
        a re-executed round reproduces its result bitwise)."""
        attempt = 0
        redirects = 0
        # seeded by name: reproducible per-client jitter, decorrelated
        # across the fleet (str seeding hashes deterministically)
        rng = random.Random(self.name)
        while True:
            try:
                return self._run()
            except _StaleEpoch as exc:
                redirects += 1
                if redirects > 64:
                    raise RuntimeError(
                        f"{self.name}: {redirects} stale-epoch redirects; "
                        "the server is advancing past every rejoin")
                self.epoch = int(exc.round)
                time.sleep(0.02)
            except (ConnectionError, TimeoutError, OSError,
                    sm.ProtocolError) as exc:
                attempt += 1
                self.faults["reconnects"] = attempt
                if attempt > self.max_reconnects:
                    raise
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * 2.0 ** (attempt - 1))
                delay *= 0.5 + rng.random() / 2.0
                time.sleep(delay)

    def _run(self) -> int:
        sock = socket.create_connection(self.address)
        conn = sm.Connection(sock)
        conn.settimeout(self.timeout_s)
        try:
            conn.send_ctrl({"type": "hello", "client": self.name,
                            "epoch": self.epoch, "proto": PROTO,
                            "fingerprint": self.fingerprint,
                            "reconnects": self.faults["reconnects"]})
            resp = conn.recv_ctrl()
            if resp.get("type") != "welcome":
                code = resp.get("code")
                if code == "stale-epoch" and "round" in resp:
                    raise _StaleEpoch(int(resp["round"]))
                if code == "duplicate":
                    # our dead predecessor socket still occupies the slot;
                    # the server sheds it when round traffic next touches
                    # it — retry through the backoff loop
                    raise ConnectionError(
                        f"{self.name}: predecessor connection still "
                        "registered; retrying")
                raise RuntimeError(
                    f"{self.name}: server rejected the handshake: "
                    f"{resp.get('reason', resp)}"
                )
            cached: dict[int, Message] = {}
            while True:
                ctrl = conn.recv_ctrl()
                kind = ctrl.get("type")
                if kind == "task":
                    rnd = int(ctrl["round"])
                    task = self._recv_task(conn)
                    # one round's cache only: grants never reach back
                    # further than the current round's fold restarts.
                    # Dropped before training, not after: on the card a
                    # full-width client would otherwise hold last
                    # round's result beside its AdamW state
                    cached.clear()
                    cached[rnd] = self.executor.execute(task)
                elif kind == "grant":
                    rnd = int(ctrl["round"])
                    if rnd not in cached:
                        raise RuntimeError(
                            f"{self.name}: granted round {rnd} but no cached "
                            f"result (have {sorted(cached)})"
                        )
                    self._send_result(conn, rnd, cached[rnd])
                    self.rounds_done = rnd + 1
                elif kind == "done":
                    return self.rounds_done
                else:
                    raise RuntimeError(
                        f"{self.name}: unexpected control frame {ctrl}")
        finally:
            conn.close()

    def _recv_task(self, conn: sm.Connection) -> Message:
        decoder = self.pipelines["task_data"].decoder()
        recv = sm.ContainerReceiver(consume=decoder.on_item,
                                    decode_item=decoder.decode_item,
                                    device=decoder.ctx.device)
        conn.recv_stream(recv.on_chunk)
        return decoder.finish(MessageKind.TASK_DATA)

    def _send_result(self, conn: sm.Connection, rnd: int,
                     result: Message) -> None:
        # fresh copy per grant: begin_encode may rewrite headers/payload,
        # and a fold restart will ask for this result again
        msg = Message(result.kind, dict(result.payload), dict(result.headers))
        pipeline = self.pipelines["task_result"]
        msg, ctx = pipeline.begin_encode(msg)
        conn.send_ctrl({"type": "result", "round": rnd, "client": self.name})
        # encode-ahead on the uplink too: quantize/crc of item k+1
        # overlaps the socket write of item k (same wire bytes)
        sm.ContainerStreamer(
            sm.ConnectionDriver(conn), self.chunk_size,
            prefetch=self.encode_ahead,
        ).send_items(
            pipeline.iter_encode_views(msg, ctx), pipeline.n_items(msg)
        )


# ---------------------------------------------------------------------------
# Sequential reference over recorded contributor sets
# ---------------------------------------------------------------------------

def _wire_roundtrip(pipeline: WirePipeline, msg: Message, kind: MessageKind,
                    chunk_size: int, sink: Optional[Any] = None) -> Message:
    """Encode → chunk → decode one message through a loopback driver —
    the exact arithmetic path of a live transfer, minus the socket."""
    decoder = pipeline.decoder(sink=sink)
    recv = sm.ContainerReceiver(consume=decoder.on_item,
                                decode_item=decoder.decode_item,
                                device=decoder.ctx.device)
    driver = sm.LoopbackDriver()
    driver.connect(recv.on_chunk)
    msg, ctx = pipeline.begin_encode(msg)
    sm.ContainerStreamer(driver, chunk_size).send_items(
        pipeline.iter_encode_views(msg, ctx), pipeline.n_items(msg))
    return decoder.finish(kind)


def reference_run(spec: Mapping[str, Any], rosters: list[list[str]],
                  init: Optional[Mapping[str, Any]] = None,
                  device: Any = None) -> dict[str, Any]:
    """Replay a federation sequentially over recorded contributor sets.

    ``rosters[r]`` is round ``r``'s contributor list *in fold order* —
    exactly what the live server records in ``round_log[r]["clients"]``.
    Each round downlinks through the task_data pipeline, executes the
    client's (pure, round-keyed) local training, and folds the uplink
    through the task_result pipeline into the same streaming aggregator,
    in the same order — so the result is **bitwise-equal** to a live run
    whose effective contributor sets matched, whatever chaos (stragglers,
    reconnects, quarantines, restarts) produced them. ``--verify-chaos``
    asserts this. Runs on ``device`` (the card unless the caller asks
    for the CPU)."""
    spec = live_spec(spec)
    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    chunk = int(spec["chunk_mb"] * (1 << 20))
    pipelines = build_pipelines_from_spec(spec, device=device)
    executors = {f"site-{i}": build_client_executor(spec, i, device=device)
                 for i in range(int(spec["clients"]))}
    weights = dict(initial_weights(spec, device) if init is None else init)
    for rnd, roster in enumerate(rosters):
        agg = build_aggregator(aggregator_spec(spec), device=device)
        for name in roster:
            task = make_task(rnd, weights)
            task.headers.setdefault("client", name)
            task = _wire_roundtrip(pipelines["task_data"], task,
                                   MessageKind.TASK_DATA, chunk)
            result = executors[name].execute(task)
            msg = Message(result.kind, dict(result.payload),
                          dict(result.headers))
            _wire_roundtrip(pipelines["task_result"], msg,
                            MessageKind.TASK_RESULT, chunk, sink=agg)
        weights = agg.finish()
    return weights


# ---------------------------------------------------------------------------
# Orchestration: spawn subprocess clients + run the server
# ---------------------------------------------------------------------------

def _reap(procs: list[subprocess.Popen],
          deadline_s: float) -> list[Optional[int]]:
    """Reap every subprocess against ONE shared deadline.

    First pass waits (bounded by what's left of the deadline) and
    escalates to ``terminate()`` on expiry; the second pass gives
    terminated processes a short window to exit, then ``kill()``s and
    always reaps — no zombie survives, and a fleet of wedged clients
    costs one deadline, not one per client."""
    if not procs:
        return []
    codes: list[Optional[int]] = [None] * len(procs)
    deadline = time.monotonic() + deadline_s
    for i, p in enumerate(procs):
        try:
            codes[i] = p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            with contextlib.suppress(OSError):
                p.terminate()
    kill_at = time.monotonic() + 5.0
    for i, p in enumerate(procs):
        if codes[i] is not None:
            continue
        try:
            codes[i] = p.wait(timeout=max(0.0, kill_at - time.monotonic()))
        except subprocess.TimeoutExpired:
            with contextlib.suppress(OSError):
                p.kill()
            codes[i] = p.wait()
    return codes


def _client_cmd(spec_path: str, index: int, address: tuple[str, int],
                device: torch.device) -> list[str]:
    return [
        sys.executable, "-m", "repro_torch.launch.federation",
        "--spec", spec_path,
        "--client-index", str(index),
        "--connect", f"{address[0]}:{address[1]}",
        "--device", str(device),
    ]


def _client_env() -> dict[str, str]:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    pp = env.get("PYTHONPATH", "")
    if src not in pp.split(os.pathsep):
        env["PYTHONPATH"] = f"{src}{os.pathsep}{pp}" if pp else src
    return env


def run_live_federation(
    spec: Mapping[str, Any],
    clients: Optional[int] = None,
    rounds: Optional[int] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    uplink: str = "ordered",
    join_timeout_s: float = 120.0,
    round_timeout_s: float = 600.0,
    spawn: bool = True,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    device: Any = None,
    on_listen: Optional[Callable[["FederationServer"], None]] = None,
) -> dict[str, Any]:
    """Run one real federation: server in this process, clients as
    subprocesses (``spawn=True``) or left to the caller (``spawn=False``
    — e.g. clients on other machines pointing at ``port``, or
    :class:`FederationClient` threads of this process, which
    ``on_listen(server)`` may start at ``server.address`` once the
    server listens and before the rounds begin). The server runs on
    ``device`` and passes it on to the clients it spawns.

    A ``"chaos"`` spec block (``{client_name: fault_plan}``) routes each
    named client through its own :class:`ChaosProxy` with that plan —
    the fault-injection harness for tests and the chaos-smoke CI job.
    The chaos block never reaches the subprocess spec (clients must not
    know they are being sabotaged).

    Returns final weights, the per-round log (contributors, stragglers,
    wall seconds), the per-grant ``uplink_log``, wire byte totals, fault
    counters, the telemetry snapshot, and the clients' exit codes.
    """
    spec = live_spec(spec, clients=clients, rounds=rounds)
    server = FederationServer(
        spec, host=host, port=port, uplink=uplink,
        join_timeout_s=join_timeout_s, round_timeout_s=round_timeout_s,
        checkpoint_dir=checkpoint_dir, resume=resume, device=device,
    ).start()
    procs: list[subprocess.Popen] = []
    proxies: dict[str, ChaosProxy] = {}
    spec_path: Optional[str] = None
    t0 = time.monotonic()
    try:
        if spawn:
            for name, plan in dict(spec.get("chaos") or {}).items():
                proxies[name] = ChaosProxy(server.address, plan).start()
            # subprocesses must see the *fully resolved* spec (clients /
            # rounds overrides included): the partition is keyed by the
            # client count, so a drifting spec would train on wrong data
            fd, spec_path = tempfile.mkstemp(suffix=".json",
                                             prefix="live_spec_")
            with os.fdopen(fd, "w") as fh:
                json.dump({k: v for k, v in spec.items()
                           if k not in ("trace", "chaos")}, fh)
            for i in range(server.n_clients):
                name = f"site-{i}"
                addr = (proxies[name].address if name in proxies
                        else server.address)
                procs.append(subprocess.Popen(
                    _client_cmd(spec_path, i, addr, server.device),
                    env=_client_env(),
                ))
        elif on_listen is not None:
            on_listen(server)
        final = server.run(initial_weights(spec, server.device))
        wall_s = time.monotonic() - t0
        exit_codes = _reap(procs, 60.0)
        return {
            "final_weights": final,
            "address": server.address,
            "round_log": server.round_log,
            "uplink_log": server.uplink_log,
            "bytes_down": server.bytes_down,
            "bytes_up": server.bytes_up,
            "restarts": server.restarts,
            "rejects": server.rejects,
            "faults": server.faults,
            "resumed_from": server.resumed_from,
            "telemetry": server.metrics.snapshot(),
            "wall_s": round(wall_s, 6),
            "client_exit_codes": exit_codes,
        }
    finally:
        # always-reap: terminate-then-kill with one shared deadline, so
        # a wedged fleet can't leak zombies or stall shutdown for 60s×N
        _reap(procs, 5.0)
        for proxy in proxies.values():
            proxy.close()
        server.close()
        if spec_path is not None:
            with contextlib.suppress(OSError):
                os.unlink(spec_path)


# ---------------------------------------------------------------------------
# CLI: `python -m repro_torch.launch.federation`
# ---------------------------------------------------------------------------

def _parse_address(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.federation",
        description="Run a real multi-process federation from a job spec "
                    "(server mode), or one client of it (--client-index).",
    )
    ap.add_argument("--spec", required=True, help="path to a JSON job spec")
    ap.add_argument("--clients", type=int, default=None,
                    help="override the spec's client count (server mode)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the spec's round count (server mode)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--uplink", choices=UPLINK_MODES, default="ordered")
    ap.add_argument("--join-timeout", type=float, default=120.0)
    ap.add_argument("--round-timeout", type=float, default=600.0)
    ap.add_argument("--no-spawn", action="store_true",
                    help="server only; clients connect from elsewhere")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="atomically persist round epoch + global weights "
                         "+ roster here after every round (overrides the "
                         'spec\'s "checkpoint" key)')
    ap.add_argument("--resume", action="store_true",
                    help="restart from the newest checkpoint in "
                         "--checkpoint-dir at round k+1 with "
                         "bitwise-identical weights")
    ap.add_argument("--trace", metavar="OUT_JSON", default=None,
                    help="write the server's Chrome trace-event file "
                         "(open in Perfetto)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the run summary as JSON")
    ap.add_argument("--verify-sim", action="store_true",
                    help="also run the sequential simulator on the same spec "
                         "and fail unless final weights are bitwise-equal")
    ap.add_argument("--verify-chaos", action="store_true",
                    help="replay the run's recorded per-round contributor "
                         "sets sequentially (reference_run) and fail unless "
                         "final weights are bitwise-equal — the equivalence "
                         "check that survives stragglers/reconnects/resume")
    ap.add_argument("--client-index", type=int, default=None,
                    help="client mode: which roster slot this process is")
    ap.add_argument("--connect", metavar="HOST:PORT", default=None,
                    help="client mode: the server address")
    ap.add_argument("--epoch", type=int, default=0,
                    help="client mode: round epoch to present (rejoin)")
    ap.add_argument("--device", default=None,
                    help="torch device of the server and the clients it "
                         "spawns (default: cuda, which must be present)")
    args = ap.parse_args(argv)

    with open(args.spec) as fh:
        spec = json.load(fh)

    if args.client_index is not None:
        if not args.connect:
            ap.error("--client-index requires --connect HOST:PORT")
        client = FederationClient.for_spec(
            spec, args.client_index, _parse_address(args.connect),
            epoch=args.epoch, timeout_s=args.round_timeout, device=args.device,
        )
        client.run()
        return 0

    if args.trace:
        spec["trace"] = args.trace
    result = run_live_federation(
        spec, clients=args.clients, rounds=args.rounds,
        host=args.host, port=args.port, uplink=args.uplink,
        join_timeout_s=args.join_timeout, round_timeout_s=args.round_timeout,
        spawn=not args.no_spawn,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        device=args.device,
    )
    final = result.pop("final_weights")
    result["weights_sha256"] = hashlib.sha256(
        b"".join(as_numpy(final[k]).tobytes() for k in sorted(final))
    ).hexdigest()

    if args.verify_chaos:
        # the recorded contributor sets are the ground truth: replaying
        # them sequentially must land on the same bits, whatever faults
        # shaped them (a resumed run's restored round_log covers the
        # pre-crash rounds too, so one check spans the server restart)
        ref_spec = {k: v for k, v in live_spec(
            spec, clients=args.clients, rounds=args.rounds).items()
            if k not in ("trace", "chaos")}
        rosters = [list(r["clients"]) for r in result.get("round_log", [])]
        ref = reference_run(ref_spec, rosters, device=args.device)
        equal = weights_bitwise_equal(final, ref)
        result["chaos_ref_equal"] = equal
        if not equal:
            out = json.dumps(result, indent=1, default=str)
            if args.json:
                with open(args.json, "w") as fh:
                    fh.write(out + "\n")
            print(out)
            print("FAIL: live weights differ from the sequential reference "
                  "over the recorded contributor sets", file=sys.stderr)
            return 1

    if args.verify_sim:
        from repro_torch.fl.job import run_job

        sim_spec = {k: v for k, v in live_spec(
            spec, clients=args.clients, rounds=args.rounds).items()
            if k != "trace"}
        sim = run_job(sim_spec, device=args.device)
        equal = weights_bitwise_equal(final, sim["final_weights"])
        result["sim_bitwise_equal"] = equal
        # wall-vs-sim per-round timing: the live server and the
        # sequential controller record the same round_log shape, so the
        # summary can show where deployment overhead (process hops, TCP
        # framing, stragglers) lands round by round
        result["round_timing"] = [
            {
                "round": lv.get("round", i),
                "live_wall_s": lv.get("wall_s"),
                "sim_wall_s": sv.get("wall_s"),
                "delta_s": round(float(lv.get("wall_s", 0.0))
                                 - float(sv.get("wall_s", 0.0)), 6),
            }
            for i, (lv, sv) in enumerate(
                zip(result.get("round_log", []), sim.get("round_log", []))
            )
        ]
        if not equal:
            out = json.dumps(result, indent=1, default=str)
            if args.json:
                with open(args.json, "w") as fh:
                    fh.write(out + "\n")
            print(out)
            print("FAIL: live weights differ from the sequential simulator",
                  file=sys.stderr)
            return 1

    out = json.dumps(result, indent=1, default=str)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
