"""Event-driven federated scheduler: concurrent clients on a simulated clock.

Mirror of ``src/repro/runtime/scheduler.py``. The sequential controller
(``ScatterAndGather``) drives clients one after another, so round time is
the *sum* of client times. This scheduler runs the same pipelined,
streamed round trips **concurrently** — a thread pool executes the real
transport (serialization, framing, byte counts), the local training and
the quantize launches — while a deterministic
:class:`~repro_torch.runtime.events.EventLoop` orders everything in
simulated time:

    dispatch --downlink--> arrival --compute--> ... --uplink--> completion

Link and compute durations come from the :class:`NetworkModel`, driven by
the *actual* wire bytes each hop produced.

Determinism: real executions finish on worker threads in any wall-clock
order, but their results are folded into the policy strictly in
(simulated time, schedule seq) order, and every random draw (jitter,
dropout) comes from seeded streams keyed by stable strings. Event times
depend only on wire bytes and seeds, so the timeline, ``sim_time_s`` and
:class:`RuntimeStats` are independent of ``max_concurrency``. Stateful
stages and filters are serialized under the simulator's ``filter_lock``.

On CUDA every worker launches on the default stream, so no tensor that
crosses threads needs an event. A worker's exception propagates through
``future.result()`` and ends the run; it never becomes a dropout, a
retry or a CPU run.

Fault injection: each dispatch attempt may drop out (seeded Bernoulli,
``dropout_prob``) partway through its round trip; the scheduler
re-dispatches up to ``max_retries`` times, then reports the client as
failed to the policy. Chunk-level faults (``chunk_drop_prob``,
``chunk_dup_prob``, ``chunk_reorder_window`` on the simulator's
``SimulationConfig``) ride underneath: the proxies' transport runs every
hop through :class:`~repro_torch.core.resilience.LossyDriver` and
:class:`~repro_torch.core.resilience.ReliableTransfer`, and the
retransmitted bytes feed the simulated clock.

Client availability: an optional :class:`AvailabilityTrace` gives each
client arrival/departure windows. A dispatch to an offline client is
**deferred** to the client's next arrival; a departure mid round trip
**interrupts** the trip and re-dispatches on return, without consuming
retry budget. A client that never returns is reported failed.
"""
from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from random import Random
from collections.abc import Sequence
from typing import Any, Optional

from repro_torch.fl.controller import ClientProxy
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.async_agg import AggregationPolicy, Dispatch
from repro_torch.runtime.events import AvailabilityTrace, Event, EventKind, EventLoop
from repro_torch.runtime.network import NetworkModel


@dataclasses.dataclass
class RuntimeConfig:
    """Knobs for the async runtime (transport knobs stay in SimulationConfig)."""

    seed: int = 0
    max_concurrency: int = 8
    dropout_prob: float = 0.0
    max_retries: int = 2
    drop_after_frac: float = 0.5   # dropout strikes this far through the round trip


@dataclasses.dataclass
class RuntimeStats:
    dispatches: int = 0
    completions: int = 0
    dropouts: int = 0
    retries: int = 0
    failed_clients: int = 0
    model_updates: int = 0
    deferrals: int = 0      # dispatches parked until a client's arrival
    interruptions: int = 0  # round trips cut short by a client departure
    settle_waves: int = 0   # calls into the settle loop
    settled_futures: int = 0  # round trips timestamped (== dispatches at end)
    partial_settles: int = 0  # settles that stopped early, leaving trips in flight
    sim_time_s: float = 0.0
    events_processed: int = 0  # events popped off the simulated-time queue
    queue_depth_peak: int = 0  # high-water mark of the event queue

    # every field is deterministic across identical-seed runs (wall-clock
    # elapsed deliberately lives on the scheduler, not here — run results
    # embed this dict and tests compare them across runs)
    def as_dict(self) -> dict[str, Any]:
        """JSON-safe export (the metrics-snapshot schema)."""
        return dataclasses.asdict(self)


class AsyncFLScheduler:
    """Runs an :class:`AggregationPolicy` over real client proxies.

    ``streaming_agg=True`` switches the result path to streaming
    aggregation: worker threads run downlink + compute + a byte-pricing
    pass over the uplink (so simulated times are fed the same true wire
    bytes as ever), and the *fold* transfer — decode one item, fold it
    into the policy's per-item running state, free it — runs at the
    COMPLETION instant on the scheduler thread, in simulated-time order.
    One fold stream is live at a time, so server-side
    transmission+aggregation memory peaks at ~one item regardless of how
    many clients are in flight, and fold order is fully deterministic.
    Requires proxies exposing ``stream_task`` (the simulator's proxies
    do) and a stateless task_result pipeline; proxies without it fall
    back to the batch path transparently.
    """

    def __init__(
        self,
        proxies: Sequence[ClientProxy],
        policy: AggregationPolicy,
        network: Optional[NetworkModel] = None,
        config: Optional[RuntimeConfig] = None,
        availability: Optional[AvailabilityTrace] = None,
        streaming_agg: bool = False,
    ) -> None:
        if not proxies:
            raise ValueError("need at least one client proxy")
        self.proxies: dict[str, ClientProxy] = {p.name: p for p in proxies}
        if len(self.proxies) != len(proxies):
            raise ValueError("client proxy names must be unique")
        self.policy = policy
        self.config = config or RuntimeConfig()
        self.network = network or NetworkModel(seed=self.config.seed)
        self.availability = availability
        self.streaming_agg = streaming_agg
        self.loop = EventLoop()
        self.stats = RuntimeStats()
        self.wall_elapsed_s = 0.0  # host time of the last run() (not in stats)
        self._drop_rng = Random(f"dropout:{self.config.seed}")
        # (dispatch, dispatch_sim_time, future) in launch order
        self._inflight: list[tuple[Dispatch, float, Future]] = []

    # -- real execution (worker threads) ------------------------------------
    def _execute(self, dispatch: Dispatch) -> Any:
        proxy = self.proxies[dispatch.client]
        if self.streaming_agg and hasattr(proxy, "stream_task"):
            return proxy.stream_task(dispatch.task)  # deferred-uplink handle
        return proxy.submit_task(dispatch.task)

    def _fail_client(self, dispatch: Dispatch, pool: ThreadPoolExecutor) -> None:
        self.stats.failed_clients += 1
        for d in self.policy.on_client_failed(dispatch):
            self._launch(d, pool)

    def _launch(self, dispatch: Dispatch, pool: ThreadPoolExecutor) -> None:
        if self.availability is not None and not self.availability.is_online(
            dispatch.client, self.loop.now
        ):
            arrival = self.availability.next_arrival(dispatch.client, self.loop.now)
            if math.isinf(arrival):  # departed for good: permanent failure
                self._fail_client(dispatch, pool)
                return
            self.stats.deferrals += 1
            self.loop.schedule_at(arrival, EventKind.DEFERRED, dispatch.client,
                                  dispatch=dispatch)
            return
        self.stats.dispatches += 1
        self.loop.schedule(0.0, EventKind.DISPATCH, dispatch.client,
                           version=dispatch.version, attempt=dispatch.attempt)
        self._inflight.append((dispatch, self.loop.now, pool.submit(self._execute, dispatch)))

    # -- folding real results into simulated time ---------------------------
    def _earliest_possible(self, dispatch: Dispatch, t0: float) -> float:
        """Hard lower bound on the simulated time of any event this
        in-flight round trip can produce (its ARRIVAL, a DROPOUT that
        strikes partway through the minimum-duration trip, or an
        INTERRUPT at the client's scheduled departure)."""
        lat, comp = self.network.floor_seconds(dispatch.client)
        bound = t0 + min(lat, self.config.drop_after_frac * (2.0 * lat + comp))
        if self.availability is not None:
            bound = min(bound, self.availability.online_until(dispatch.client, t0))
        return bound

    def _must_settle(self) -> bool:
        """True when an in-flight trip could still beat the next queued
        event in simulated time — only then does the loop block on real
        results. Otherwise queued events are processed first, leaving
        in-flight transports running in parallel on the pool."""
        if not self._inflight:
            return False
        if self.loop.empty:
            return True
        next_t = self.loop.peek().time
        return any(
            self._earliest_possible(d, t0) < next_t for d, t0, _ in self._inflight
        )

    def _settle(self) -> None:
        """Timestamp in-flight round trips, in launch order, stopping as
        soon as no remaining trip can beat the queue's head.

        Event *times* depend only on bytes + seeds, never on which
        worker thread finished first, and futures are settled in launch
        order, so the timeline is deterministic. The early stop is the
        settle-wave relaxation (profiled at 200 clients): the old
        full-wave barrier blocked on *every* in-flight future before
        processing the next event, so one wall-clock straggler stalled
        the whole loop even when its earliest possible event lay far in
        the simulated future. Settling only the launch-order prefix that
        can still affect the next event lets queued completions process
        — and their follow-up dispatches launch — while stragglers keep
        running on the pool. The dropout RNG is consumed in launch order
        either way, so timelines are unchanged.
        """
        self.stats.settle_waves += 1
        pending = self._inflight
        self._inflight = []
        while pending:
            if not self.loop.empty:
                next_t = self.loop.peek().time
                if all(self._earliest_possible(d, t0) >= next_t
                       for d, t0, _ in pending):
                    self._inflight = pending
                    self.stats.partial_settles += 1
                    return
            dispatch, t0, future = pending.pop(0)
            self._settle_one(dispatch, t0, future)
            self.stats.settled_futures += 1

    def _settle_one(self, dispatch: Dispatch, t0: float, future: Future) -> None:
        """Wait for one round trip and schedule its timeline events."""
        result = future.result()
        # true bytes-on-wire (frames + envelopes + retransmissions) as
        # stamped by the simulator wire; payload size is the fallback
        # for proxies that don't measure their transport
        down = int(result.headers.get("wire_bytes_down", dispatch.task.payload_bytes()))
        up = int(result.headers.get("wire_bytes_up", result.payload_bytes()))
        t_down = self.network.transfer_seconds(dispatch.client, down)
        t_compute = self.network.compute_seconds(dispatch.client)
        t_up = self.network.transfer_seconds(dispatch.client, up)
        total = t_down + t_compute + t_up
        departs = (
            self.availability.online_until(dispatch.client, t0)
            if self.availability is not None else math.inf
        )
        dropped = self._drop_rng.random() < self.config.dropout_prob
        drop_t = t0 + self.config.drop_after_frac * total
        tr = obs_trace.ACTIVE
        if dropped and drop_t < departs:
            if tr is not None:
                tr.sim_span("trip.dropped", t0, drop_t, track=dispatch.client,
                            cat="trip", version=dispatch.version,
                            attempt=dispatch.attempt)
            self.loop.schedule_at(drop_t, EventKind.DROPOUT, dispatch.client,
                                  dispatch=dispatch)
        elif t0 + total > departs:
            # client leaves mid round trip: the trip dies at the
            # departure instant and re-dispatches on the next arrival
            if tr is not None:
                tr.sim_span("trip.interrupted", t0, departs, track=dispatch.client,
                            cat="trip", version=dispatch.version,
                            attempt=dispatch.attempt)
            if t0 + t_down < departs:
                self.loop.schedule_at(t0 + t_down, EventKind.ARRIVAL, dispatch.client,
                                      version=dispatch.version)
            self.loop.schedule_at(departs, EventKind.INTERRUPT, dispatch.client,
                                  dispatch=dispatch)
        else:
            if tr is not None:
                # the round trip's simulated anatomy, one track per client
                c = dispatch.client
                tr.sim_span("downlink", t0, t0 + t_down, track=c, cat="trip",
                            version=dispatch.version, attempt=dispatch.attempt,
                            wire_bytes=down)
                tr.sim_span("compute", t0 + t_down, t0 + t_down + t_compute,
                            track=c, cat="trip", version=dispatch.version)
                tr.sim_span("uplink", t0 + t_down + t_compute, t0 + total,
                            track=c, cat="trip", version=dispatch.version,
                            wire_bytes=up)
            self.loop.schedule_at(t0 + t_down, EventKind.ARRIVAL, dispatch.client,
                                  version=dispatch.version)
            self.loop.schedule_at(
                t0 + total,
                EventKind.COMPLETION,
                dispatch.client,
                dispatch=dispatch,
                result=result,
            )

    # -- event handlers (scheduler thread, simulated-time order) ------------
    def _handle(self, event: Event, pool: ThreadPoolExecutor) -> None:
        if event.kind is EventKind.COMPLETION:
            self.stats.completions += 1
            dispatch: Dispatch = event.data["dispatch"]
            result = event.data["result"]
            before = self.policy.model_version
            if hasattr(result, "deliver"):
                # streaming aggregation: the uplink fold transfer runs
                # NOW, on this thread, in simulated-time order — one
                # decoded item live at a time, straight into the
                # policy's per-item running state
                follow_ups = self.policy.on_result_stream(
                    dispatch, result.headers, result.deliver
                )
            else:
                follow_ups = self.policy.on_result(dispatch, result)
            if self.policy.model_version != before:
                self.stats.model_updates += 1
                self.loop.schedule(0.0, EventKind.MODEL_UPDATE,
                                   version=self.policy.model_version)
            for d in follow_ups:
                self._launch(d, pool)
        elif event.kind is EventKind.DROPOUT:
            self.stats.dropouts += 1
            dispatch = event.data["dispatch"]
            if dispatch.attempt < self.config.max_retries:
                self.stats.retries += 1
                retry = Dispatch(dispatch.client, dispatch.task,
                                 dispatch.version, dispatch.attempt + 1)
                self.loop.schedule(0.0, EventKind.RETRY, dispatch.client,
                                   attempt=retry.attempt)
                self._launch(retry, pool)
            else:
                self._fail_client(dispatch, pool)
        elif event.kind is EventKind.DEFERRED:
            # the client just arrived: launch the parked dispatch for real
            self._launch(event.data["dispatch"], pool)
        elif event.kind is EventKind.INTERRUPT:
            # departure killed the trip; re-dispatch (defers to next
            # arrival). Availability churn never consumes retry budget.
            self.stats.interruptions += 1
            self._launch(event.data["dispatch"], pool)
        # DISPATCH / ARRIVAL / RETRY / MODEL_UPDATE are timeline markers

    # -- main loop -----------------------------------------------------------
    def run(self, initial_weights: dict[str, Any]) -> dict[str, Any]:
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=self.config.max_concurrency) as pool:
            for d in self.policy.begin(dict(initial_weights), list(self.proxies)):
                self._launch(d, pool)
            while self._inflight or not self.loop.empty:
                if self._must_settle():
                    tr = obs_trace.ACTIVE
                    if tr is None:
                        self._settle()
                    else:
                        with tr.span("sched.settle", "sched",
                                     inflight=len(self._inflight)):
                            self._settle()
                if self.loop.empty:
                    break
                depth = len(self.loop)
                if depth > self.stats.queue_depth_peak:
                    self.stats.queue_depth_peak = depth
                event = self.loop.pop()
                self.stats.events_processed += 1
                tr = obs_trace.ACTIVE
                if tr is not None:
                    # timeline markers on the simulated clock: one track
                    # per client plus the queue-depth counter series
                    tr.sim_instant(event.kind.value, event.time,
                                   track=event.client or "scheduler",
                                   cat="event", seq=event.seq)
                    tr.sim_counter("queue_depth", event.time, depth - 1)
                self._handle(event, pool)
        self.wall_elapsed_s = time.perf_counter() - t_start
        self.stats.sim_time_s = self.loop.now
        if not self.policy.complete:
            raise RuntimeError(
                f"{self.policy.name}: federation ended before the policy "
                "completed its budget (did every client drop out?)"
            )
        return self.policy.finish()

    @property
    def timeline(self) -> list[Event]:
        """Processed events in simulated-time order (the run's trace)."""
        return list(self.loop.history)
