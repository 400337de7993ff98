"""Server-side Controller (paper §II-A, Fig. 2).

:class:`ScatterAndGather` implements the canonical FL workflow: its
``run()`` loop broadcasts Task Data (global weights) to every client
proxy, gathers Task Results (local updates), aggregates, and repeats.
Transport, filtering and streaming live behind the :class:`ClientProxy`
interface so the same controller runs over the in-process simulator, TCP
drivers, or the mesh view.
"""
from __future__ import annotations

import inspect
import time
from collections.abc import Callable, Mapping, Sequence
from typing import Any, Optional

from repro_torch.core.messages import Message, MessageKind
from repro_torch.obs import trace as obs_trace


def make_task(rnd: int, global_weights: Mapping[str, Any]) -> Message:
    """Build one round's Task Data message.

    The reference shares it with its async runtime's policies so both
    construct byte-identical tasks; the port keeps the same function.
    """
    return Message(
        MessageKind.TASK_DATA,
        dict(global_weights),
        headers={"round": rnd, "task_name": "train"},
    )


class ClientProxy:
    """What the Controller sees of one client site.

    ``result_sink`` (optional) is the streaming-aggregation hook: a
    proxy that supports it feeds the Task Result's decoded items into
    ``sink.begin(meta)`` / ``sink.accept_item(name, value, weight)``
    *during* the uplink transfer and returns a payload-less Message
    (headers only) — the server never materializes the client's payload
    dict. Proxies that ignore the argument simply return the full result
    for batch aggregation.
    """

    name: str = "client"

    def submit_task(self, task: Message, result_sink: Optional[Any] = None) -> Message:
        raise NotImplementedError


class ScatterAndGather:
    def __init__(
        self,
        clients: Sequence[ClientProxy],
        aggregator: Any,
        num_rounds: int,
        on_round_end: Optional[Callable[[int, dict[str, Any], list[Message]], None]] = None,
        streaming: bool = False,
    ) -> None:
        """``streaming=True`` hands the aggregator to each proxy as the
        uplink result sink: one decoded item is folded into the running
        aggregate and freed before the next arrives, so server peak
        memory is ~one item instead of one model. Clients run one at a
        time in list order either way, so streaming and batch aggregation
        execute *identical arithmetic in identical order* — bitwise-equal
        final weights (tested). Requires an aggregator implementing the
        :class:`~repro_torch.fl.aggregator.Aggregator` streaming protocol."""
        if not clients:
            raise ValueError("need at least one client")
        self.clients = list(clients)
        self.aggregator = aggregator
        self.num_rounds = num_rounds
        self.on_round_end = on_round_end
        self.streaming = streaming
        # per-round wall timing, same entry shape the live federation
        # server records — the --verify-sim summary zips the two
        self.round_log: list[dict[str, Any]] = []
        if streaming and not (
            hasattr(aggregator, "begin") and hasattr(aggregator, "accept_item")
        ):
            raise TypeError(
                f"streaming aggregation needs the begin/accept_item/finish "
                f"protocol; {type(aggregator).__name__} lacks it (see the "
                "README migration note for custom aggregators)"
            )
        if streaming:
            for c in self.clients:
                try:
                    accepts = "result_sink" in inspect.signature(
                        c.submit_task
                    ).parameters
                except (TypeError, ValueError):  # uninspectable: trust it
                    accepts = True
                if not accepts:
                    raise TypeError(
                        f"client proxy {type(c).__name__} predates streaming "
                        "aggregation: its submit_task takes no result_sink "
                        "argument — add the parameter (see ClientProxy) or "
                        "run without streaming"
                    )

    def run(self, initial_weights: dict[str, Any]) -> dict[str, Any]:
        """The Controller's run() method (paper §II-A): task distribution

        and aggregation of returns."""
        global_weights = dict(initial_weights)
        self.round_log = []
        for rnd in range(self.num_rounds):
            results: list[Message] = []
            t0 = time.monotonic()
            with obs_trace.span("round", "round", round=rnd):
                for client in self.clients:
                    task = make_task(rnd, global_weights)
                    with obs_trace.span("client.round_trip", "round",
                                        round=rnd, client=client.name):
                        if self.streaming:
                            # the uplink wire folds each decoded item straight
                            # into the aggregator; result carries headers only
                            result = client.submit_task(
                                task, result_sink=self.aggregator
                            )
                        else:
                            result = client.submit_task(task)
                            self.aggregator.accept(result)
                    results.append(result)
                global_weights = self.aggregator.finish()
            self.round_log.append({
                "round": rnd,
                "clients": len(results),
                "wall_s": time.monotonic() - t0,
            })
            if self.on_round_end is not None:
                self.on_round_end(rnd, global_weights, results)
        return global_weights
