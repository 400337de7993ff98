"""Reads what the program produces at its layer boundaries during the
set-up round, for :mod:`fedbench.check` to judge once the window has
closed.

Two boundaries of the federation are wrapped for that one round and
restored before the window opens:

* each client's executor (``proxy.executor.execute``): the decoded
  downlink it receives (sampled, and copied whole so the change its
  local steps make can be measured leaf by leaf), the trained
  weights it returns (sampled), the loss it reports;
* the server's aggregator (``accept_item``): each uplink item as the
  server receives it, codes and scales or decoded values (sampled).

The round's result, the new global weights, is sampled by the caller.
"""
from __future__ import annotations

import math
import time
from typing import Any

import torch

from fedbench import check


def _keep(payload: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A copy of the decoded downlink that outlives the local steps (which
    update it in place): on the card where its memory leaves room for a
    client's training beside it (weights, gradients and two moments, and
    a margin), else on the host."""
    first = next(iter(payload.values()))
    nbytes = sum(t.numel() * t.element_size() for t in payload.values())
    if first.device.type == "cuda" and \
            torch.cuda.mem_get_info(first.device)[0] >= 5 * nbytes + 4e9:
        return {n: t.detach().clone() for n, t in payload.items()}
    return {n: t.detach().to("cpu", copy=True) for n, t in payload.items()}


class Capture:
    def __init__(self, segs: dict[str, list[int]]) -> None:
        self.segs = segs
        self.clients: list[dict[str, Any]] = []
        self.seconds = 0.0          # spent capturing, outside the program's calls
        self._undo: list[tuple[Any, str]] = []

    def install(self, sim: Any) -> None:
        for proxy in sim.proxies:
            self._wrap(proxy.executor, "execute", self._executor_hook(proxy.executor.execute))
        agg = sim.controller.aggregator
        self._wrap(agg, "accept_item", self._aggregator_hook(agg.accept_item))

    def remove(self) -> None:
        for obj, attr in self._undo:
            delattr(obj, attr)
        self._undo = []

    def _wrap(self, obj: Any, attr: str, fn: Any) -> None:
        setattr(obj, attr, fn)
        self._undo.append((obj, attr))

    def _executor_hook(self, execute: Any) -> Any:
        def hooked(task: Any) -> Any:
            t0 = time.perf_counter()
            start = _keep(task.payload)
            rec: dict[str, Any] = {
                "start": {n: check.sample_values(t, self.segs[n]) for n, t in start.items()},
                "uplink": {},
            }
            self.clients.append(rec)
            t1 = time.perf_counter()
            result = execute(task)
            t2 = time.perf_counter()
            out = result.payload
            rec["trained"] = {n: check.sample_values(t, self.segs[n]) for n, t in out.items()}
            rec["change_norm"] = {}
            for n, t in out.items():
                diff = t.detach() - start.pop(n).to(t.device)
                rec["change_norm"][n] = float(torch.linalg.vector_norm(diff, dtype=torch.float64))
                del diff
            rec["loss"] = float(result.headers["metrics"]["loss"])
            self.seconds += (t1 - t0) + (time.perf_counter() - t2)
            return result
        return hooked

    def _aggregator_hook(self, accept_item: Any) -> Any:
        def hooked(name: str, value: Any, weight: float) -> Any:
            segs = self.segs[name]
            if hasattr(value, "absmax") and hasattr(value, "payload"):
                n = math.prod(value.orig_shape)
                item: Any = [(c.reshape(-1), a) for c, a in
                             check.sample_codes(value.payload, value.absmax, n, value.fmt, segs)]
            else:
                item = check.sample_values(torch.as_tensor(value), segs)
            self.clients[-1]["uplink"][name] = item
            return accept_item(name, value, weight)
        return hooked

    def result(self, new_global: dict[str, Any]) -> dict[str, Any]:
        return {"clients": self.clients,
                "global": {n: check.sample_values(t, self.segs[n]) for n, t in new_global.items()}}
