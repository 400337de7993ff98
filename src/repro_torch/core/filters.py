"""NVFlare-style filter mechanism (paper §II-B) and the two-way
quantization workflow built on it (paper §II-C).

Mirror of ``src/repro/core/filters.py``. Filters transform messages at the
four points of a federated round:

* ``TASK_DATA_OUT``    — before Task Data leaves the server
* ``TASK_DATA_IN``     — before clients accept Task Data
* ``TASK_RESULT_OUT``  — before Task Result leaves a client
* ``TASK_RESULT_IN``   — before the server accepts a Task Result

The two-way quantization scheme installs a :class:`QuantizeFilter` on both
*OUT* points and a :class:`DequantizeFilter` on both *IN* points, so every
message crosses the wire quantized while training and aggregation always
see original precision.

Every filter that quantizes or dequantizes runs on a ``device``: the CUDA
kernels for the card (the default, which raises without CUDA), their
plain versions for ``"cpu"``. Quantized payloads stay on that device
until the wire serializes them; dequantized tensors land there.

Arithmetic follows the reference's: its kernels flush float32 subnormals
and the port's do too, while the DP noise sum and the error-feedback
residuals are plain IEEE float32 arithmetic (numpy there, torch here),
which keeps them.

.. deprecated:: as in the reference, the ``Filter``/``FilterChain``
   surface is superseded by the registry-driven
   :class:`~repro_torch.core.pipeline.WirePipeline`, whose stages run per
   item inside the streaming loop; the simulator adapts filter chains onto
   whole-message pipeline stages via
   :func:`~repro_torch.core.pipeline.legacy_wire_pipelines`.
"""
from __future__ import annotations

import enum
import math
from collections.abc import Callable, Iterable
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.messages import Message
from repro_torch.core.quantization import (
    QuantizedTensor,
    dequantize_state_dict,
    quantize_state_dict,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_tensor, numpy_dtype


class FilterPoint(enum.Enum):
    TASK_DATA_OUT = "task_data_out"        # server egress
    TASK_DATA_IN = "task_data_in"          # client ingress
    TASK_RESULT_OUT = "task_result_out"    # client egress
    TASK_RESULT_IN = "task_result_in"      # server ingress


class Filter:
    """Message transform. Stateless unless documented otherwise."""

    def process(self, message: Message) -> Message:
        raise NotImplementedError


class FilterChain:
    def __init__(self, filters: Optional[Iterable[Filter]] = None) -> None:
        self.filters: list[Filter] = list(filters or [])

    def process(self, message: Message) -> Message:
        for f in self.filters:
            message = f.process(message)
        return message


def _is_float(value: Any) -> bool:
    """A plain floating array or tensor (QuantizedTensor items are not)."""
    if isinstance(value, QuantizedTensor):
        return False
    if isinstance(value, torch.Tensor):
        return value.is_floating_point()
    return bool(np.issubdtype(np.asarray(value).dtype, np.floating))


def _numel(value: Any) -> int:
    return math.prod(value.shape) if hasattr(value, "shape") else int(np.asarray(value).size)


class QuantizeFilter(Filter):
    """Quantize every float tensor in the payload to ``fmt``, one item at a
    time (one kernel launch per blocked item on the card).

    Already-quantized items and small/integer tensors pass through
    unchanged.
    """

    def __init__(self, fmt: str, min_params: int = 0, device: Any = None) -> None:
        self.fmt = fmt
        self.min_params = min_params
        self.device = resolve_device(device)

    def process(self, message: Message) -> Message:
        out: dict[str, Any] = {}
        for name, value in message.payload.items():
            if not _is_float(value) or _numel(value) < self.min_params:
                out[name] = value
                continue
            out[name] = quantize_state_dict({name: value}, self.fmt, self.device)[name]
        msg = message.replace_payload(out)
        msg.headers["quantized_fmt"] = self.fmt
        return msg


class DequantizeFilter(Filter):
    """Recover original precision for every QuantizedTensor item, onto
    ``device``."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)

    def process(self, message: Message) -> Message:
        q = {n: v for n, v in message.payload.items() if isinstance(v, QuantizedTensor)}
        out = {n: v for n, v in message.payload.items() if not isinstance(v, QuantizedTensor)}
        out.update(dequantize_state_dict(q, self.device))
        # preserve original insertion order
        ordered = {n: out[n] for n in message.payload.keys()}
        msg = message.replace_payload(ordered)
        msg.headers.pop("quantized_fmt", None)
        return msg


def gaussian_noise(rng: np.random.Generator, sigma: float, value: Any) -> Any:
    """``value`` plus the reference's noise draw: ``rng.normal(0, sigma,
    shape)`` in float64, cast to the value's dtype, added in that dtype
    (IEEE, subnormals kept) — in numpy for an array, on the tensor's
    device for a tensor. Shared by the DP filter and the ``dp-noise``
    stage, which draw from their generators in item order."""
    if isinstance(value, torch.Tensor):
        noise = rng.normal(0.0, sigma, tuple(value.shape)).astype(numpy_dtype(value.dtype))
        return value + torch.from_numpy(noise).to(value.device)
    arr = np.asarray(value)
    return arr + rng.normal(0.0, sigma, arr.shape).astype(arr.dtype)


class DPGaussianNoiseFilter(Filter):
    """Gaussian-mechanism DP filter: install it *before* the quantize
    filter on TASK_RESULT_OUT so noise is added at full precision, then
    quantized for the wire. One generator per instance, drawn in message
    and item order — a job shares one instance across its clients."""

    def __init__(self, sigma: float, seed: int = 0) -> None:
        self.sigma = sigma
        self._rng = np.random.default_rng(seed)

    def process(self, message: Message) -> Message:
        out: dict[str, Any] = {}
        for name, value in message.payload.items():
            out[name] = gaussian_noise(self._rng, self.sigma, value) \
                if _is_float(value) else value
        return message.replace_payload(out)


class SelectiveQuantizeFilter(Filter):
    """Per-layer precision policy: a list of (substring, fmt) rules
    decides each tensor's format; first match wins; ``default_fmt`` covers
    the rest; fmt None = keep original precision."""

    def __init__(self, rules, default_fmt: str = "nf4", min_params: int = 0,
                 device: Any = None) -> None:
        self.rules = list(rules)
        self.default_fmt = default_fmt
        self.min_params = min_params
        self.device = resolve_device(device)

    def _fmt_for(self, name: str) -> Optional[str]:
        for substr, fmt in self.rules:
            if substr in name:
                return fmt
        return self.default_fmt

    def process(self, message: Message) -> Message:
        out: dict[str, Any] = {}
        fmts = set()
        for name, value in message.payload.items():
            fmt = self._fmt_for(name)
            if fmt is None or not _is_float(value) or _numel(value) < self.min_params:
                out[name] = value
                continue
            out[name] = quantize_state_dict({name: value}, fmt, self.device)[name]
            fmts.add(fmt)
        msg = message.replace_payload(out)
        msg.headers["quantized_fmt"] = "mixed:" + ",".join(sorted(fmts))
        return msg


class ErrorFeedbackQuantizeFilter(Filter):
    """Quantize with error feedback: keeps the per-tensor quantization
    residual e_t and transmits Q(x_t + e_{t-1}).

    Stateful, and keyed by tensor name only, as the reference's: one
    instance shared by every client of a hop keeps one residual stream
    per name across them all. The residuals are float32 tensors on
    ``device``.
    """

    def __init__(self, fmt: str, min_params: int = 0, device: Any = None) -> None:
        self.fmt = fmt
        self.min_params = min_params
        self.device = resolve_device(device)
        self._residual: dict[str, torch.Tensor] = {}

    def process(self, message: Message) -> Message:
        out: dict[str, Any] = {}
        for name, value in message.payload.items():
            if not _is_float(value) or _numel(value) < self.min_params:
                out[name] = value
                continue
            arr = as_tensor(value, self.device).to(torch.float32)
            corrected = arr + self._residual.get(name, 0.0)
            qt = quantize_state_dict({name: corrected}, self.fmt, self.device)[name]
            deq = dequantize_state_dict({name: qt}, self.device)[name].to(torch.float32)
            self._residual[name] = corrected - deq
            out[name] = qt
        msg = message.replace_payload(out)
        msg.headers["quantized_fmt"] = self.fmt
        msg.headers["error_feedback"] = True
        return msg


def _network_link_fn(network: Any) -> Callable[[str], float]:
    """client -> bits/s from a NetworkModel (or anything link()-shaped)."""
    fn = getattr(network, "bandwidth_bps", None)
    if callable(fn):
        return fn
    return lambda client: network.link(client).bandwidth_mbps * 1e6


class AdaptiveQuantizeFilter(Filter):
    """Bandwidth-adaptive precision: picks the cheapest format whose
    estimated transfer time fits the round's bandwidth budget, falling
    back toward fp32 when the link is fast enough to afford fidelity.

    Bandwidth comes from ``link_fn(client) -> bits/s`` for messages with
    a ``client`` header (bind one with :meth:`bind_network`), else from
    the fleet-wide ``bandwidth_bps``. ``last_fmt_by_client`` records the
    most recent decision per client (key ``""`` for unattributed
    messages). The decision is pure arithmetic over shapes; ``device``
    is where a chosen format is quantized, resolved when it is.
    """

    LADDER = ("fp32", "fp16", "blockwise8", "nf4")
    BITS = {"fp32": 32, "fp16": 16, "blockwise8": 8 + 32 / 4096, "nf4": 4 + 32 / 64}

    def __init__(
        self,
        bandwidth_bps: Optional[float] = None,
        budget_s: float = 1.0,
        min_params: int = 0,
        link_fn: Optional[Callable[[str], float]] = None,
        device: Any = None,
    ) -> None:
        if bandwidth_bps is None and link_fn is None:
            raise ValueError("need bandwidth_bps, link_fn, or bind_network()")
        self.bandwidth_bps = bandwidth_bps
        self.budget_s = budget_s
        self.min_params = min_params
        self.link_fn = link_fn
        self.device = device
        self.last_fmt: Optional[str] = None
        self.last_fmt_by_client: dict[str, str] = {}

    @classmethod
    def from_network(
        cls, network: Any, budget_s: float = 1.0, min_params: int = 0,
        device: Any = None,
    ) -> AdaptiveQuantizeFilter:
        """Link-aware construction: no fleet-wide fallback, so a message
        without a ``client`` header raises rather than guessing."""
        return cls(budget_s=budget_s, min_params=min_params,
                   link_fn=_network_link_fn(network), device=device)

    def bind_network(self, network: Any) -> None:
        """Feed per-client bandwidth from ``network.link(client)``."""
        self.link_fn = _network_link_fn(network)

    def _bandwidth_for(self, client: Optional[str]) -> float:
        if self.link_fn is not None and client:
            return float(self.link_fn(client))
        if self.bandwidth_bps is None:
            raise ValueError(
                "AdaptiveQuantizeFilter has only a per-client link_fn but the "
                "message carries no 'client' header; set bandwidth_bps as fallback"
            )
        return self.bandwidth_bps

    def _payload_bits(self, message: Message, fmt: str) -> float:
        n = sum(_numel(v) for v in message.payload.values() if _is_float(v))
        return n * self.BITS[fmt]

    def fmt_for(self, message: Message) -> str:
        """The precision this filter would pick for ``message`` (pure)."""
        bandwidth = self._bandwidth_for(message.headers.get("client"))
        for cand in self.LADDER:
            if self._payload_bits(message, cand) / bandwidth <= self.budget_s:
                return cand
        return self.LADDER[-1]

    def process(self, message: Message) -> Message:
        fmt = self.fmt_for(message)
        self.last_fmt = fmt
        self.last_fmt_by_client[str(message.headers.get("client", ""))] = fmt
        if fmt == "fp32":
            return message
        return QuantizeFilter(fmt, self.min_params, self.device).process(message)


def two_way_quantization(fmt: str, device: Any = None) -> dict[FilterPoint, FilterChain]:
    """The paper's §II-C scheme: quantize on both egress points,
    dequantize on both ingress points."""
    return {
        FilterPoint.TASK_DATA_OUT: FilterChain([QuantizeFilter(fmt, device=device)]),
        FilterPoint.TASK_DATA_IN: FilterChain([DequantizeFilter(device)]),
        FilterPoint.TASK_RESULT_OUT: FilterChain([QuantizeFilter(fmt, device=device)]),
        FilterPoint.TASK_RESULT_IN: FilterChain([DequantizeFilter(device)]),
    }


def no_filters() -> dict[FilterPoint, FilterChain]:
    return {p: FilterChain() for p in FilterPoint}
