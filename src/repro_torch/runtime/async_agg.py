"""Aggregation policies for the event-driven scheduler.

Mirror of ``src/repro/runtime/async_agg.py``. Four policies make
synchronous FedAvg "one policy among several":

* :class:`SyncPolicy` — a barrier per round. It buffers each round's
  Task Results as they complete (in any simulated order) and feeds the
  aggregator **in client-list order**, exactly the order the sequential
  :class:`~repro_torch.fl.controller.ScatterAndGather` loop uses; tasks
  are built by the same :func:`~repro_torch.fl.controller.make_task`.
* :class:`FedBuffPolicy` — buffered asynchronous aggregation (FedBuff,
  Nguyen et al. 2022): every completed client immediately gets a fresh
  task built from the *current* global model; client deltas accumulate
  in a size-K buffer weighted by ``num_samples * (1 + staleness)^-alpha``
  and each flush applies the weighted-mean delta at ``server_lr``.
* :class:`FedAsyncPolicy` — per-update mixing (FedAsync, Xie et al.
  2019): ``w <- (1 - a_t) w + a_t w_client`` with ``a_t = mixing_rate *
  (1 + staleness)^-alpha``.
* :class:`TieredPolicy` — TiFL-style tiered selection (Chai et al.
  2020): each round runs over one latency tier only.

The barrier-free policies keep the global weights, the delta sums and
the mixes as float32 tensors on the policy's ``device``. Their
arithmetic is the reference's numpy arithmetic, step for step: scalars
become float32 0-d device tensors (numpy casts a Python float operand of
a float32 array to float32, and a CUDA tensor divided by a host scalar
would be multiplied by its reciprocal instead), and every operation is
its own eager op, evaluated in the reference's order and rounded on its
own (a fused kernel could contract a product and a sum into one FMA).

Streaming aggregation (``server_streaming_agg``) swaps the result path
to :meth:`AggregationPolicy.on_result_stream`: the policy receives a
``deliver(sink)`` callable that runs the uplink fold transfer at the
completion instant, pushing one decoded item at a time into the sink.
"""
from __future__ import annotations

import dataclasses
from random import Random
from collections.abc import Callable, Mapping, Sequence
from typing import Any, Optional

import torch

from repro_torch.core.filters import _is_float
from repro_torch.core.messages import Message, MessageKind
from repro_torch.fl.aggregator import CollectingSink
from repro_torch.fl.controller import make_task
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_tensor


@dataclasses.dataclass
class Dispatch:
    """One task handed to one client: what the scheduler launches."""

    client: str
    task: Message
    version: int          # global model version the task was built from
    attempt: int = 0      # dropout retry counter (scheduler-managed)


def _f32(value: Any, device: torch.device) -> torch.Tensor:
    return as_tensor(value, device).to(torch.float32)


def _scalar(x: float, device: torch.device) -> torch.Tensor:
    """A Python float as numpy uses it against a float32 array: rounded
    to float32, here as a 0-d tensor on ``device``."""
    return torch.tensor(x, dtype=torch.float32, device=device)


class AggregationPolicy:
    """What the scheduler asks of an aggregation/workflow policy.

    ``device`` is where the policy's tensors live (``None``: CUDA)."""

    name = "policy"
    device: Any = None

    def begin(self, initial_weights: Mapping[str, Any], clients: Sequence[str]) -> list[Dispatch]:
        raise NotImplementedError

    def on_result(self, dispatch: Dispatch, result: Message) -> list[Dispatch]:
        raise NotImplementedError

    def on_result_stream(
        self,
        dispatch: Dispatch,
        headers: Mapping[str, Any],
        deliver: Callable[[Any], Message],
    ) -> list[Dispatch]:
        """Streaming-aggregation result path: called at the simulated
        completion instant (event order, scheduler thread) *instead of*
        :meth:`on_result`. ``deliver(sink)`` runs the uplink fold
        transfer, pushing each decoded item through ``sink.begin``/
        ``sink.accept_item`` — call it at most once.

        The default adapts any policy that only implements
        :meth:`on_result`: items are collected back into a payload dict
        (no memory win, full compatibility).
        """
        sink = CollectingSink(self.device)
        msg = deliver(sink)
        return self.on_result(dispatch, Message(msg.kind, sink.finish(), dict(msg.headers)))

    def on_client_failed(self, dispatch: Dispatch) -> list[Dispatch]:
        """Called when a client exhausted its dropout retries."""
        return []

    @property
    def complete(self) -> bool:
        raise NotImplementedError

    @property
    def model_version(self) -> int:
        raise NotImplementedError

    def finish(self) -> dict[str, Any]:
        raise NotImplementedError


class SyncPolicy(AggregationPolicy):
    """Round-barrier FedAvg over the async scheduler.

    Results may *complete* in any simulated order, but aggregation per
    round runs in client-list order once the barrier closes, so the
    output bits match the sequential controller. (Under streaming
    aggregation the fold instead runs at each completion instant, in
    completion order.) Clients that permanently dropped out are skipped.
    Subclasses may narrow each round to a cohort by overriding
    :meth:`_select_round_clients` (see :class:`TieredPolicy`).
    """

    name = "sync"

    def __init__(
        self,
        aggregator: Any,
        num_rounds: int,
        on_round_end: Optional[Callable[[int, dict[str, Any], list[Message]], None]] = None,
    ) -> None:
        self.aggregator = aggregator
        self.num_rounds = num_rounds
        self.on_round_end = on_round_end
        self._clients: list[str] = []
        self._round_clients: list[str] = []
        self._round = 0
        self._weights: dict[str, Any] = {}
        self._results: dict[str, Message] = {}
        self._failed: set = set()
        self._streamed: set = set()  # clients already folded via streaming

    def begin(self, initial_weights, clients):
        self._clients = list(clients)
        self._weights = dict(initial_weights)
        self._round = 0
        if self.num_rounds <= 0:  # match ScatterAndGather: no rounds, no work
            return []
        return self._dispatch_round()

    def _select_round_clients(self) -> list[str]:
        """The cohort for the round about to start (default: everyone)."""
        return list(self._clients)

    def _dispatch_round(self) -> list[Dispatch]:
        self._results = {}
        self._failed = set()
        self._streamed = set()
        self._round_clients = self._select_round_clients()
        return [
            Dispatch(c, make_task(self._round, self._weights), version=self._round)
            for c in self._round_clients
        ]

    def _round_done(self) -> bool:
        return len(self._results) + len(self._failed) >= len(self._round_clients)

    def _close_round(self) -> list[Dispatch]:
        ordered = [self._results[c] for c in self._round_clients if c in self._results]
        # batch contributions fold now, in client-list order (the
        # sequential controller's order); streamed ones already folded
        for c in self._round_clients:
            if c in self._results and c not in self._streamed:
                self.aggregator.accept(self._results[c])
        self._weights = self.aggregator.finish()
        if self.on_round_end is not None:
            self.on_round_end(self._round, self._weights, ordered)
        self._round += 1
        if self._round < self.num_rounds:
            return self._dispatch_round()
        return []

    def on_result(self, dispatch, result):
        if dispatch.version != self._round:
            return []  # stale straggler from an already-closed round
        self._results[dispatch.client] = result
        return self._close_round() if self._round_done() else []

    def on_result_stream(self, dispatch, headers, deliver):
        """Streaming barrier: each completing client folds straight into
        the aggregator's per-item running sums at its completion instant;
        the policy keeps header-only records. Bitwise-equal to the batch
        barrier whenever completion order matches client-list order."""
        if dispatch.version != self._round:
            return []  # stale straggler from an already-closed round
        self._streamed.add(dispatch.client)
        deliver(self.aggregator)
        self._results[dispatch.client] = Message(
            MessageKind.TASK_RESULT, {}, dict(headers)
        )
        return self._close_round() if self._round_done() else []

    def on_client_failed(self, dispatch):
        if dispatch.version != self._round:
            return []
        self._failed.add(dispatch.client)
        if not self._results and self._round_done():
            raise RuntimeError(f"round {self._round}: every client dropped out")
        return self._close_round() if self._round_done() else []

    @property
    def complete(self) -> bool:
        return self._round >= self.num_rounds

    @property
    def model_version(self) -> int:
        return self._round

    def finish(self):
        return dict(self._weights)


def polynomial_staleness(alpha: float = 0.5) -> Callable[[int], float]:
    """FedBuff's polynomial staleness discount: (1 + s)^-alpha."""

    def weight(staleness: int) -> float:
        return float((1.0 + max(0, staleness)) ** (-alpha))

    return weight


class _BudgetedAsyncPolicy(AggregationPolicy):
    """Shared machinery for barrier-free policies with a client-task
    budget (:class:`FedBuffPolicy`, :class:`FedAsyncPolicy`): dispatch
    bookkeeping, float32 weight coercion onto ``device``, and the
    completion criterion (every dispatched task processed or lost)."""

    def __init__(self, total_tasks: int, device: Any = None) -> None:
        self.total_tasks = total_tasks
        self.device = resolve_device(device)
        self._weights: dict[str, Any] = {}
        self._version = 0
        self._dispatched = 0
        self._done = 0          # results processed
        self._lost = 0          # permanently failed clients' tasks
        self.staleness_seen: list[int] = []

    def _next_task(self, client: str) -> list[Dispatch]:
        if self._dispatched >= self.total_tasks:
            return []
        self._dispatched += 1
        return [Dispatch(client, make_task(self._version, self._weights), version=self._version)]

    def begin(self, initial_weights, clients):
        self._weights = {
            n: _f32(v, self.device) if _is_float(v) else v
            for n, v in initial_weights.items()
        }
        out: list[Dispatch] = []
        for c in clients:
            out.extend(self._next_task(c))
        return out

    def on_client_failed(self, dispatch):
        self._lost += 1
        return []

    @property
    def complete(self) -> bool:
        return self._done + self._lost >= self._dispatched and self._dispatched >= self.total_tasks

    @property
    def model_version(self) -> int:
        return self._version

    def finish(self):
        return dict(self._weights)


def _fold_delta(policy: FedBuffPolicy, name: str, value: Any, base: Any,
                w: torch.Tensor) -> None:
    """``sums[name] += (value - base) * w`` in float32, the subtraction,
    the product and the sum each rounded on their own."""
    delta = (_f32(value, policy.device) - _f32(base, policy.device)) * w
    sums = policy._delta_sum
    if name in sums:
        sums[name] += delta
    else:
        sums[name] = delta


def _mix(policy: FedAsyncPolicy, name: str, cur: Any, value: Any, a: float) -> None:
    """``w <- (1 - a) * w + a * value`` in float32, as the reference
    evaluates it (``1 - a`` in double, then each product and the sum)."""
    dev = policy.device
    policy._weights[name] = (
        _scalar(1.0 - a, dev) * _f32(cur, dev) + _scalar(a, dev) * _f32(value, dev)
    )


class _FedBuffFoldSink:
    """Per-dispatch streaming sink for FedBuff: folds ``(value - base) *
    w`` into the policy's shared per-item delta sums the moment each item
    decodes — the arithmetic and item order of the batch ``on_result``
    loop, so streaming and batch aggregation are bitwise-equal. ``base``
    is the dispatched task payload (tensors shared with the global model
    snapshot, which no flush writes into)."""

    def __init__(self, policy: FedBuffPolicy, dispatch: Dispatch, w: float) -> None:
        self._policy = policy
        self._base = dispatch.task.payload
        self._w = w
        self._w_t = _scalar(w, policy.device)

    def begin(self, meta: Mapping[str, Any]) -> float:
        return self._w  # staleness weight fixed at the completion instant

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        base = self._base.get(name)
        if base is None or not _is_float(value):
            return
        _fold_delta(self._policy, name, value, base, self._w_t)


class _FedAsyncFoldSink:
    """Per-dispatch streaming sink for FedAsync: applies the per-item mix
    as each item decodes — the op and item order of the batch
    ``on_result`` loop."""

    def __init__(self, policy: FedAsyncPolicy, a: float) -> None:
        self._policy = policy
        self._a = a

    def begin(self, meta: Mapping[str, Any]) -> float:
        return self._a

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        cur = self._policy._weights.get(name)
        if cur is None or not _is_float(value):
            return
        _mix(self._policy, name, cur, value, self._a)


class FedBuffPolicy(_BudgetedAsyncPolicy):
    """Staleness-weighted buffered async aggregation.

    ``total_tasks`` is the client-task budget; ``buffer_size`` is K, the
    number of client updates folded into one server step.
    """

    name = "fedbuff"

    def __init__(
        self,
        total_tasks: int,
        buffer_size: int = 4,
        server_lr: float = 1.0,
        staleness_weight: Optional[Callable[[int], float]] = None,
        on_update: Optional[Callable[[int, dict[str, Any]], None]] = None,
        device: Any = None,
    ) -> None:
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        super().__init__(total_tasks, device)
        self.buffer_size = buffer_size
        self.server_lr = server_lr
        self.staleness_weight = staleness_weight or polynomial_staleness()
        self.on_update = on_update
        self._delta_sum: dict[str, torch.Tensor] = {}
        self._wsum = 0.0
        self._buffered = 0

    def _flush(self) -> None:
        if self._buffered == 0 or self._wsum <= 0:
            return
        lr = _scalar(self.server_lr, self.device)
        wsum = _scalar(self._wsum, self.device)
        for name, dsum in self._delta_sum.items():
            # new tensors, never in place: pending dispatches' bases are
            # the current weights
            self._weights[name] = _f32(self._weights[name], self.device) + lr * dsum / wsum
        self._version += 1
        self._delta_sum = {}
        self._wsum = 0.0
        self._buffered = 0
        if self.on_update is not None:
            self.on_update(self._version, self._weights)

    def on_result(self, dispatch, result):
        staleness = self._version - dispatch.version
        self.staleness_seen.append(staleness)
        w = float(result.headers.get("num_samples", 1)) * self.staleness_weight(staleness)
        if w > 0:
            w_t = _scalar(w, self.device)
            for name, value in result.payload.items():
                base = dispatch.task.payload.get(name)
                if base is None or not _is_float(value):
                    continue
                _fold_delta(self, name, value, base, w_t)
            self._wsum += w
            self._buffered += 1
        self._done += 1
        if self._buffered >= self.buffer_size:
            self._flush()
        return self._next_task(dispatch.client)

    def on_result_stream(self, dispatch, headers, deliver):
        """Streaming FedBuff: the delta buffer *is* the per-item running
        state — each arriving item's weighted delta folds into it during
        the uplink transfer; bitwise-equal to :meth:`on_result`."""
        staleness = self._version - dispatch.version
        self.staleness_seen.append(staleness)
        w = float(headers.get("num_samples", 1)) * self.staleness_weight(staleness)
        if w > 0:
            deliver(_FedBuffFoldSink(self, dispatch, w))
            self._wsum += w
            self._buffered += 1
        self._done += 1
        if self._buffered >= self.buffer_size:
            self._flush()
        return self._next_task(dispatch.client)

    def finish(self):
        self._flush()  # partial buffer still carries information
        return dict(self._weights)


class FedAsyncPolicy(_BudgetedAsyncPolicy):
    """FedAsync (Xie et al. 2019): per-update server mixing,

        a_t = mixing_rate * (1 + staleness)^-alpha
        w  <- (1 - a_t) * w + a_t * w_client

    one server step (and model version) per client update.
    """

    name = "fedasync"

    def __init__(
        self,
        total_tasks: int,
        mixing_rate: float = 0.6,
        staleness_weight: Optional[Callable[[int], float]] = None,
        on_update: Optional[Callable[[int, dict[str, Any]], None]] = None,
        device: Any = None,
    ) -> None:
        if not 0.0 < mixing_rate <= 1.0:
            raise ValueError("mixing_rate must be in (0, 1]")
        super().__init__(total_tasks, device)
        self.mixing_rate = mixing_rate
        self.staleness_weight = staleness_weight or polynomial_staleness()
        self.on_update = on_update

    def on_result(self, dispatch, result):
        staleness = self._version - dispatch.version
        self.staleness_seen.append(staleness)
        a = self.mixing_rate * self.staleness_weight(staleness)
        for name, value in result.payload.items():
            cur = self._weights.get(name)
            if cur is None or not _is_float(value):
                continue
            _mix(self, name, cur, value, a)
        self._version += 1
        self._done += 1
        if self.on_update is not None:
            self.on_update(self._version, self._weights)
        return self._next_task(dispatch.client)

    def on_result_stream(self, dispatch, headers, deliver):
        """Streaming FedAsync: the global model *is* the per-item running
        state — each arriving item is mixed in during the uplink
        transfer; bitwise-equal to :meth:`on_result`."""
        staleness = self._version - dispatch.version
        self.staleness_seen.append(staleness)
        a = self.mixing_rate * self.staleness_weight(staleness)
        deliver(_FedAsyncFoldSink(self, a))
        self._version += 1
        self._done += 1
        if self.on_update is not None:
            self.on_update(self._version, self._weights)
        return self._next_task(dispatch.client)


class TieredPolicy(SyncPolicy):
    """TiFL-style tiered client selection (Chai et al. 2020).

    Clients are profiled for expected round latency, sorted, and split
    into ``num_tiers`` equal-size buckets; every round draws **one** tier
    (seeded uniform over eligible tiers) and runs a sync FedAvg round
    over that tier only.

    Profiling: ``latency_fn(client) -> seconds`` if given; else, with a
    :class:`~repro_torch.runtime.network.NetworkModel`, the jitter-free
    estimate ``2 * link.base_seconds(probe_bytes) + compute`` per client;
    else clients are bucketed in client-list order. ``credits`` (per
    tier) bounds how many rounds any tier may serve until every tier's
    credits are spent.
    """

    name = "tiered"

    def __init__(
        self,
        aggregator: Any,
        num_rounds: int,
        num_tiers: int = 3,
        latency_fn: Optional[Callable[[str], float]] = None,
        network: Optional[Any] = None,   # repro_torch.runtime.network.NetworkModel
        probe_bytes: int = 1 << 20,
        credits: Optional[int] = None,
        seed: int = 0,
        on_round_end: Optional[Callable[[int, dict[str, Any], list[Message]], None]] = None,
    ) -> None:
        if num_tiers < 1:
            raise ValueError("num_tiers must be >= 1")
        super().__init__(aggregator, num_rounds, on_round_end)
        self.num_tiers = num_tiers
        self.latency_fn = latency_fn
        self.network = network
        self.probe_bytes = probe_bytes
        self.credits = credits
        self._rng = Random(f"tiered:{seed}")
        self.tiers: list[list[str]] = []
        self.tier_of: dict[str, int] = {}
        self.profiled_latency: dict[str, float] = {}
        self.selected_tiers: list[int] = []
        self._credits_left: list[int] = []

    def _estimate_latency(self, client: str) -> float:
        if self.latency_fn is not None:
            return float(self.latency_fn(client))
        if self.network is not None:
            link = self.network.link(client)
            _, compute = self.network.floor_seconds(client)
            return 2.0 * link.base_seconds(self.probe_bytes) + compute
        return 0.0  # no profile: stable sort keeps client-list order

    def begin(self, initial_weights, clients):
        clients = list(clients)
        self.profiled_latency = {c: self._estimate_latency(c) for c in clients}
        by_latency = sorted(clients, key=lambda c: self.profiled_latency[c])
        k = min(self.num_tiers, len(clients))
        bounds = [round(i * len(by_latency) / k) for i in range(k + 1)]
        self.tiers = [by_latency[bounds[i]:bounds[i + 1]] for i in range(k)]
        self.tier_of = {c: i for i, tier in enumerate(self.tiers) for c in tier}
        self._credits_left = [self.credits or 0] * len(self.tiers)
        self.selected_tiers = []
        return super().begin(initial_weights, clients)

    def _select_round_clients(self) -> list[str]:
        eligible = [i for i, left in enumerate(self._credits_left) if left > 0]
        if not eligible:  # no credit scheme, or all spent: every tier eligible
            eligible = list(range(len(self.tiers)))
        idx = eligible[self._rng.randrange(len(eligible))]
        if self._credits_left[idx] > 0:
            self._credits_left[idx] -= 1
        self.selected_tiers.append(idx)
        return list(self.tiers[idx])


# ---------------------------------------------------------------------------
# Policy registry (the job system resolves "runtime.policy" names here)
# ---------------------------------------------------------------------------

#: name -> builder(r, ctx) -> Optional[AggregationPolicy]. ``r`` is the raw
#: job-spec ``"runtime"`` dict; ``ctx`` carries what the job system already
#: built (aggregator, rounds, client_names, network, seed, total_tasks,
#: staleness, device). Returning None selects the scheduler's default
#: SyncPolicy.
_POLICIES: dict[str, Callable[[Mapping[str, Any], Mapping[str, Any]],
                              Optional[AggregationPolicy]]] = {}


def register_policy(name: str):
    """Decorator binding a spec name to a policy builder."""

    def deco(builder):
        if name in _POLICIES:
            raise ValueError(f"policy name {name!r} already registered ({_POLICIES[name]})")
        _POLICIES[name] = builder
        return builder

    return deco


def registered_policies() -> tuple:
    return tuple(sorted(_POLICIES))


def build_policy(name: str, r: Mapping[str, Any],
                 ctx: Mapping[str, Any]) -> Optional[AggregationPolicy]:
    try:
        builder = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown runtime policy {name!r}; pick from {registered_policies()}"
        ) from None
    return builder(r, ctx)


@register_policy("sync")
def _build_sync(r, ctx):
    # None -> FLSimulator installs its default SyncPolicy
    return None


@register_policy("fedbuff")
def _build_fedbuff(r, ctx):
    return FedBuffPolicy(
        ctx["total_tasks"],
        buffer_size=int(r.get("buffer_size", 4)),
        server_lr=float(r.get("server_lr", 1.0)),
        staleness_weight=ctx["staleness"],
        device=ctx.get("device"),
    )


@register_policy("fedasync")
def _build_fedasync(r, ctx):
    return FedAsyncPolicy(
        ctx["total_tasks"],
        mixing_rate=float(r.get("mixing_rate", 0.6)),
        staleness_weight=ctx["staleness"],
        device=ctx.get("device"),
    )


@register_policy("tiered")
def _build_tiered(r, ctx):
    return TieredPolicy(
        ctx["aggregator"],
        ctx["rounds"],
        num_tiers=int(r.get("num_tiers", 3)),
        network=ctx["network"],
        credits=r.get("credits"),
        seed=ctx["seed"],
    )
