"""In-process FL simulator: wires Controller, Executors, the wire
pipelines and the streaming transport into one runnable federation.

Mirror of ``src/repro/fl/simulator.py``. Every message physically
crosses the streaming layer (encoded, framed, chunked, reassembled), so
byte counts and peak transmission memory are real. Message transforms
are :class:`~repro_torch.core.pipeline.WirePipeline` stacks, one per hop
direction (``task_data`` server->client,
``task_result`` client->server); stages execute inside the streaming
loop. :class:`TrafficStats` counts every byte that crosses a driver —
frame headers, envelopes and the transmitted header item included.

Transmission is ``container`` (one item at a time; ``file`` payloads ride
it too, as in the reference) or ``regular`` (the whole message as one
blob), over any registered driver (``loopback``, ``spool``, ``tcp``). The legacy
four-point ``Filter``/``FilterChain`` configuration
(``server_filters=``/``client_filters=``) is adapted onto whole-message
pipeline stages via :func:`~repro_torch.core.pipeline.legacy_wire_pipelines`.

Two runtimes drive the same proxies:

* the sequential :class:`~repro_torch.fl.controller.ScatterAndGather`
  controller (default — one client at a time), or
* the event-driven :class:`~repro_torch.runtime.scheduler.AsyncFLScheduler`
  (pass ``runtime=``/``policy=``/``network=``/``availability=``): clients
  run concurrently on a thread pool over the real transport, ordered by a
  deterministic simulated clock fed by actual wire bytes.

Chunk-level fault injection composes underneath: set
``chunk_drop_prob``/``chunk_dup_prob``/``chunk_reorder_window`` on
:class:`SimulationConfig` and every hop runs through
:class:`~repro_torch.core.resilience.LossyDriver` +
:class:`~repro_torch.core.resilience.ReliableTransfer`, seeded by the
reference's string key (:meth:`_Wire._fault_key`), with retransmitted
chunks counted into the wire bytes (and hence simulated time).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Callable, Sequence
from typing import Any, Optional, Union

from repro_torch.core import resilience as rs
from repro_torch.core import streaming as sm
from repro_torch.core.filters import FilterChain, FilterPoint, no_filters
from repro_torch.core.messages import Message
from repro_torch.core.pipeline import (
    IngressFilterStage,
    WirePipeline,
    legacy_wire_pipelines,
)
from repro_torch.fl.controller import ClientProxy, ScatterAndGather
from repro_torch.fl.executor import Executor
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import mem
from repro_torch.utils.mem import MemoryMeter


@dataclasses.dataclass
class SimulationConfig:
    num_rounds: int = 1
    transmission: str = "container"     # regular | container | file
    chunk_size: int = sm.DEFAULT_CHUNK_SIZE
    driver: str = "loopback"            # any registered driver name
    spool_dir: Optional[str] = None     # the spool driver's directory
    # chunk-level fault injection (loopback/spool drivers): every hop then
    # runs LossyDriver + ReliableTransfer, and retransmitted chunks are
    # counted into the wire bytes that drive simulated transfer time
    chunk_drop_prob: float = 0.0
    chunk_dup_prob: float = 0.0
    chunk_reorder_window: int = 0
    fault_seed: int = 0
    max_repair_rounds: int = 40

    def __post_init__(self) -> None:
        if self.transmission not in ("regular", "container", "file"):
            raise ValueError(f"unknown transmission {self.transmission!r}")

    @property
    def faulty(self) -> bool:
        return (
            self.chunk_drop_prob > 0
            or self.chunk_dup_prob > 0
            or self.chunk_reorder_window > 0
        )


@dataclasses.dataclass
class TrafficStats:
    """Wire-level counters: ``bytes_sent`` is true bytes on the wire
    (frame headers, envelopes, the header item); ``payload_bytes`` is the
    logical pre-transform tensor-payload size. Thread-safe."""

    messages: int = 0
    bytes_sent: int = 0
    payload_bytes: int = 0
    retransmits: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def add(self, nbytes: int, payload_nbytes: int = 0, retransmits: int = 0) -> None:
        with self._lock:
            self.messages += 1
            self.bytes_sent += int(nbytes)
            self.payload_bytes += int(payload_nbytes)
            self.retransmits += int(retransmits)

    def as_dict(self) -> dict[str, int]:
        """JSON-safe export (the metrics-snapshot schema)."""
        with self._lock:
            return {
                "messages": self.messages,
                "bytes_sent": self.bytes_sent,
                "payload_bytes": self.payload_bytes,
                "retransmits": self.retransmits,
            }


class CountingDriver(sm.Driver):
    """Transparent driver wrapper totalling encoded frame bytes."""

    def __init__(self, inner: sm.Driver) -> None:
        self.inner = inner
        self.bytes_sent = 0

    def connect(self, on_chunk: Callable[[sm.Chunk], None]) -> None:
        self.inner.connect(on_chunk)

    def send(self, chunk: sm.Chunk) -> None:
        self.bytes_sent += sm._HDR.size + chunk.nbytes
        self.inner.send(chunk)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()


class _Wire:
    """One pipelined, streamed hop: stage-encode -> frames -> reassemble
    -> stage-decode, all inside the streaming loop. A fresh driver,
    receiver and decoder per transmit, so concurrent transmits from the
    scheduler's threads share no buffers; stateful pipelines also
    serialize under the caller's lock."""

    def __init__(self, cfg: SimulationConfig, stats: TrafficStats) -> None:
        self.cfg = cfg
        self.stats = stats
        if cfg.faulty and cfg.driver == "tcp":
            raise ValueError(
                "chunk fault injection is not supported over the tcp driver "
                "(its receiver thread stops at EOF, so gap repair cannot "
                "complete); use loopback or spool"
            )

    def _driver(self) -> sm.Driver:
        kwargs: dict[str, Any] = {}
        if self.cfg.driver == "spool":
            if self.cfg.spool_dir is None:
                raise ValueError('the "spool" driver needs SimulationConfig.spool_dir')
            kwargs["spool_dir"] = self.cfg.spool_dir
        return sm.make_driver(self.cfg.driver, **kwargs)

    def _fault_key(self, message: Message) -> str:
        # stable across runs and thread interleavings: keyed by message
        # identity, not by wall-clock send order (the reference's key)
        h = message.headers
        return (
            f"wirefault:{self.cfg.fault_seed}:{h.get('client', '')}:"
            f"{message.kind.value}:{h.get('round', h.get('model_version', ''))}"
        )

    def transmit(
        self,
        message: Message,
        pipeline: WirePipeline,
        lock: Optional[threading.Lock] = None,
        sink: Optional[Any] = None,
        count_only: bool = False,
        record_stats: bool = True,
    ) -> tuple[Optional[Message], int]:
        tr = obs_trace.ACTIVE
        if tr is None:
            return self._transmit(message, pipeline, lock, sink, count_only, record_stats)
        h = message.headers
        meter = MemoryMeter.current()
        copied0, alloc0 = (meter.copied, meter.total_allocated) if meter else (0, 0)
        with tr.span("wire.transmit", "wire", kind=message.kind.value,
                     client=str(h.get("client", "")),
                     round=h.get("round", h.get("model_version")),
                     count_only=count_only, streaming_fold=sink is not None) as sp:
            out, nbytes = self._transmit(message, pipeline, lock, sink,
                                         count_only, record_stats)
            sp.args["wire_bytes"] = nbytes
            # the meter's counters over the transfer (concurrent transfers
            # of the async runtime share one meter and count in each other's)
            if meter is not None:
                sp.args["copied_bytes"] = meter.copied - copied0
                sp.args["allocated_bytes"] = meter.total_allocated - alloc0
            return out, nbytes

    def _transmit(
        self,
        message: Message,
        pipeline: WirePipeline,
        lock: Optional[threading.Lock] = None,
        sink: Optional[Any] = None,
        count_only: bool = False,
        record_stats: bool = True,
    ) -> tuple[Optional[Message], int]:
        """Send ``message`` through ``pipeline`` over one fresh driver;
        returns the received message and the true bytes put on the wire.

        ``sink`` switches the receiving end to streaming aggregation: each
        decoded item is folded via ``sink.begin``/``sink.accept_item``
        inside the receive loop, and the returned Message carries headers
        only. ``count_only`` runs the encode and framing into a null
        receiver — the byte-pricing pass the async scheduler uses before
        the deferred fold transfer (it returns no message).
        ``record_stats=False`` keeps a second pass over the same message
        out of :class:`TrafficStats`. A legacy whole-message transform's
        payload is charged to the MemoryMeter for the duration of the
        transfer. ``lock`` serializes a stateful pipeline's transfer."""
        cfg = self.cfg
        base = self._driver()
        if cfg.faulty:
            base = rs.LossyDriver(
                base,
                drop_prob=cfg.chunk_drop_prob,
                dup_prob=cfg.chunk_dup_prob,
                reorder_window=cfg.chunk_reorder_window,
                seed=self._fault_key(message),
            )
        driver = CountingDriver(base)
        regular = cfg.transmission == "regular"
        decoder: Optional[Any] = None
        if count_only:
            recv: Any = _NullReceiver()
        elif regular:
            decoder = pipeline.decoder(sink=sink)
            recv = sm.BlobReceiver(decode_container=decoder.decode_blob)
        else:
            # container streaming is also the carrier for "file" payloads,
            # as in the reference; FileStreamer moves real files
            decoder = pipeline.decoder(sink=sink)
            recv = sm.ContainerReceiver(consume=decoder.on_item,
                                        decode_item=decoder.decode_item,
                                        device=decoder.ctx.device)
        hold = lock if (lock is not None and pipeline.stateful) else contextlib.nullcontext()
        with hold:
            msg, ctx = pipeline.begin_encode(message)
            held = int(ctx.state.get("held_bytes", 0))
            if held:
                mem.record_alloc(held)
            try:
                if cfg.faulty:
                    xfer = rs.ReliableTransfer(driver, cfg.chunk_size)
                    if regular:
                        ok = xfer.send_blob(pipeline.encode_blob(msg, ctx), recv,
                                            max_rounds=cfg.max_repair_rounds)
                    else:
                        ok = xfer.send_items(pipeline.iter_encode_views(msg, ctx),
                                             pipeline.n_items(msg), recv,
                                             max_rounds=cfg.max_repair_rounds)
                    retransmits = xfer.retransmits
                    if not ok:
                        raise RuntimeError(
                            f"wire stream failed to complete within "
                            f"{cfg.max_repair_rounds} repair rounds "
                            f"(chunk_drop_prob={cfg.chunk_drop_prob})"
                        )
                else:
                    retransmits = 0
                    driver.connect(recv.on_chunk)
                    if regular:
                        sm.ObjectStreamer(driver, cfg.chunk_size).send_blob(
                            pipeline.encode_blob(msg, ctx), kind=message.kind.value)
                    else:
                        sm.ContainerStreamer(driver, cfg.chunk_size).send_items(
                            pipeline.iter_encode_views(msg, ctx), pipeline.n_items(msg),
                            kind=message.kind.value)
                    driver.flush()  # no-op unless a spool driver is underneath
                driver.close()
            finally:
                if held:
                    mem.record_free(held)
            out = (decoder.finish(msg.kind, pipeline.unsent_headers(msg))
                   if decoder is not None else None)
        if record_stats:
            self.stats.add(driver.bytes_sent, message.payload_bytes(), retransmits)
        return out, driver.bytes_sent


class _NullReceiver:
    """Byte-pricing receiver: frames arrive, nothing is reassembled."""

    def on_chunk(self, chunk: sm.Chunk) -> None:
        pass


class _SimClientProxy(ClientProxy):
    """Server-side handle for one simulated client; runs the full
    pipelined round trip (both hop directions) over the wire.

    ``filter_lock`` (async runtime only) serializes stateful pipelines so
    their state stays consistent under concurrent round trips; stateless
    pipelines stream fully concurrently."""

    def __init__(self, executor: Executor, pipelines: dict[str, WirePipeline],
                 wire: _Wire, filter_lock: Optional[threading.Lock] = None) -> None:
        self.name = executor.name
        self.executor = executor
        self.pipelines = pipelines
        self.wire = wire
        self.filter_lock = filter_lock

    def submit_task(self, task: Message, result_sink: Optional[Any] = None) -> Message:
        # destination goes in the headers so egress stages can be
        # link-aware (the adaptive stage picks per-client precision)
        task.headers.setdefault("client", self.name)
        task, wire_bytes_down = self.wire.transmit(
            task, self.pipelines["task_data"], self.filter_lock)
        result = self.executor.execute(task)
        # with a result_sink the uplink decode folds each item straight
        # into the sink (streaming aggregation); the returned message
        # then carries headers only
        result, wire_bytes_up = self.wire.transmit(
            result, self.pipelines["task_result"], self.filter_lock, sink=result_sink)
        result.headers["wire_bytes_down"] = wire_bytes_down
        result.headers["wire_bytes_up"] = wire_bytes_up
        return result

    def stream_task(self, task: Message) -> _PendingUplink:
        """Async streaming-aggregation round trip, first half: downlink,
        local compute and a byte-pricing pass over the uplink (encoded
        and framed into a null receiver). The uplink fold transfer runs
        later, via :meth:`_PendingUplink.deliver`, at the completion
        instant in simulated-time order."""
        task.headers.setdefault("client", self.name)
        task, wire_bytes_down = self.wire.transmit(
            task, self.pipelines["task_data"], self.filter_lock)
        result = self.executor.execute(task)
        _, wire_bytes_up = self.wire.transmit(
            result, self.pipelines["task_result"], self.filter_lock, count_only=True)
        headers = dict(result.headers)
        headers["wire_bytes_down"] = wire_bytes_down
        headers["wire_bytes_up"] = wire_bytes_up
        return _PendingUplink(self, result, headers)


class _PendingUplink:
    """A completed client computation whose uplink fold transfer is
    deferred: the Task Result stays with the client until the scheduler
    delivers it into a policy sink at the simulated completion instant.
    ``headers`` already carry both hops' wire byte counts (from the
    pricing pass), so the scheduler times it like a batch result."""

    def __init__(self, proxy: _SimClientProxy, result: Message,
                 headers: dict[str, Any]) -> None:
        self._proxy = proxy
        self._result = result
        self.headers = headers
        self.kind = result.kind

    def payload_bytes(self) -> int:
        return self._result.payload_bytes()

    def deliver(self, sink: Any) -> Message:
        """Run the real uplink transfer, folding each decoded item into
        ``sink``. Bytes are not counted again; a mismatch against the
        priced total would mean the simulated clock was fed wrong bytes,
        so it is a hard error."""
        out, wire_bytes = self._proxy.wire.transmit(
            self._result, self._proxy.pipelines["task_result"],
            self._proxy.filter_lock, sink=sink, record_stats=False,
        )
        if wire_bytes != self.headers["wire_bytes_up"]:
            raise RuntimeError(
                f"uplink fold transfer produced {wire_bytes} wire bytes but "
                f"the pricing pass measured {self.headers['wire_bytes_up']} — "
                "the task_result pipeline is not deterministic (stateful "
                "stages cannot run under async streaming aggregation)"
            )
        out.headers.update(
            {k: self.headers[k] for k in ("wire_bytes_down", "wire_bytes_up")}
        )
        return out


class FLSimulator:
    def __init__(
        self,
        executors: Sequence[Executor],
        aggregator: Any,
        config: Optional[SimulationConfig] = None,
        server_filters: Optional[dict[FilterPoint, FilterChain]] = None,
        client_filters: Optional[dict[FilterPoint, FilterChain]] = None,
        pipelines: Optional[dict[str, WirePipeline]] = None,
        runtime: Optional[Any] = None,   # RuntimeConfig -> async scheduler
        policy: Optional[Any] = None,    # AggregationPolicy override
        network: Optional[Any] = None,   # NetworkModel override
        availability: Optional[Any] = None,  # AvailabilityTrace
        server_streaming_agg: bool = False,
        trace: Union[Tracer, bool, None] = None,
        device: Any = None,
    ) -> None:
        """``pipelines`` maps hop direction -> :class:`WirePipeline`
        (missing directions get the identity pipeline on ``device``).
        ``server_filters``/``client_filters`` are the legacy four-point
        Filter configuration, adapted onto whole-message pipeline stages
        (the full transformed payload is materialized before streaming);
        mutually exclusive with ``pipelines``.
        ``server_streaming_agg=True`` folds Task Result items into the
        aggregation plane one at a time as they decode. On the sequential
        controller the fold runs during the uplink transfer
        (bitwise-equal to batch aggregation: same order, same
        arithmetic); on the async scheduler the uplink is priced on the
        worker thread and the fold transfer runs at the simulated
        completion instant in event order, which requires a *stateless*
        task_result pipeline.

        Any of ``runtime``/``policy``/``network``/``availability`` selects
        the async scheduler (default policy: :class:`SyncPolicy` over
        ``aggregator``)."""
        self.config = config or SimulationConfig()
        if pipelines is not None and (server_filters is not None or client_filters is not None):
            raise ValueError("pass either pipelines= or the legacy *_filters=, not both")
        if pipelines is not None:
            unknown = set(pipelines) - {"task_data", "task_result"}
            if unknown:
                raise ValueError(f"unknown pipeline directions {sorted(unknown)}")
            self.pipelines = {
                hop: pipelines.get(hop) or WirePipeline([], device=device)
                for hop in ("task_data", "task_result")
            }
        else:
            self.pipelines = legacy_wire_pipelines(
                server_filters or no_filters(), client_filters or no_filters(), device
            )
        if server_streaming_agg and any(
                isinstance(s, IngressFilterStage)
                for s in self.pipelines["task_result"].stages):
            raise ValueError(
                "streaming aggregation folds items as they decode, but a "
                "legacy server-ingress filter (TASK_RESULT_IN, e.g. "
                "DequantizeFilter) transforms the payload only after full "
                "reassembly; declare the uplink as per-item pipeline "
                'stages instead (e.g. "quantize:nf4" — decode is '
                "automatic from the envelope)"
            )
        use_async = (
            runtime is not None or policy is not None
            or network is not None or availability is not None
        )
        if server_streaming_agg and use_async and self.pipelines["task_result"].stateful:
            raise ValueError(
                "async streaming aggregation encodes each uplink twice (a "
                "byte-pricing pass, then the fold transfer), so the "
                "task_result pipeline must be stateless — ef-quantize, "
                "dp-noise, delta and stateful legacy filters cannot run "
                "there; use the sequential controller or stateless stages"
            )
        self.stats = TrafficStats()
        self.meter = MemoryMeter()
        self.server_streaming_agg = server_streaming_agg
        self.tracer: Optional[Tracer] = (
            trace if isinstance(trace, Tracer) else (Tracer() if trace else None)
        )
        self.metrics = MetricsRegistry()
        wire = _Wire(self.config, self.stats)
        filter_lock = threading.Lock() if use_async else None
        self.proxies = [_SimClientProxy(ex, self.pipelines, wire, filter_lock)
                        for ex in executors]
        self.controller: Optional[ScatterAndGather] = None
        self.scheduler: Optional[Any] = None
        if use_async:
            # imported here: repro_torch.runtime imports repro_torch.fl.controller
            from repro_torch.runtime.async_agg import SyncPolicy
            from repro_torch.runtime.scheduler import AsyncFLScheduler, RuntimeConfig

            self.scheduler = AsyncFLScheduler(
                self.proxies,
                policy or SyncPolicy(aggregator, self.config.num_rounds),
                network=network,
                config=runtime or RuntimeConfig(),
                availability=availability,
                streaming_agg=server_streaming_agg,
            )
        else:
            self.controller = ScatterAndGather(
                self.proxies, aggregator, self.config.num_rounds,
                streaming=server_streaming_agg,
            )

    def run(self, initial_weights: dict[str, Any]) -> dict[str, Any]:
        driver = self.scheduler if self.scheduler is not None else self.controller
        tracing: Any = contextlib.nullcontext()
        if self.tracer is not None:
            if self.scheduler is not None and self.tracer.sim_clock is None:
                # wall-clock spans also carry the simulated time they ran at
                loop = self.scheduler.loop
                self.tracer.sim_clock = lambda: loop.now
            tracing = obs_trace.activate(self.tracer)
        with tracing, self.meter.activate(), obs_metrics.activate(self.metrics):
            out = driver.run(initial_weights)
        self.metrics.publish("traffic", self.stats.as_dict())
        self.metrics.publish("memory", self.meter.as_dict())
        if self.scheduler is not None:
            self.metrics.publish("runtime", self.scheduler.stats.as_dict())
        return out

    def telemetry(self) -> dict[str, Any]:
        """JSON-safe observability summary: wire / memory stats, the
        metrics snapshot, and a flight-recorder summary when tracing."""
        out: dict[str, Any] = {
            "traffic": self.stats.as_dict(),
            "memory": self.meter.as_dict(),
            "metrics": self.metrics.snapshot(),
        }
        if self.scheduler is not None:
            out["runtime"] = self.scheduler.stats.as_dict()
        if self.tracer is not None:
            out["trace"] = {
                "total_events": self.tracer.total_events,
                "dropped_events": self.tracer.dropped,
                "capacity": self.tracer.capacity,
            }
        return out

    @property
    def round_log(self) -> list[dict[str, Any]]:
        """Per-round wall timing from the sequential controller; empty
        under the async scheduler, whose clock is simulated."""
        if self.controller is None:
            return []
        return list(self.controller.round_log)

    @property
    def sim_time_s(self) -> Optional[float]:
        """Simulated makespan (async runtime only; None for the sequential path)."""
        if self.scheduler is None:
            return None
        return self.scheduler.stats.sim_time_s
