"""Server-side aggregation — the streaming-first aggregation plane.

Mirror of ``src/repro/fl/aggregator.py``. Aggregators implement one
uniform **streaming protocol**, registry-keyed like pipeline stages:

* ``begin(meta) -> weight`` — a client contribution starts; ``meta`` is
  the transmitted message-header dict. Returns the sample weight every
  subsequent ``accept_item`` call for this contribution carries.
* ``accept_item(name, value, weight)`` — one payload item of one
  contribution, folded into the running aggregate immediately (called
  straight from the wire decode loop).
* ``finish() -> dict`` — close the aggregate and reset.

``accept(message)`` is the batch shim: it drives the same protocol
methods in payload order, so batch and streaming aggregation run
identical arithmetic in identical order.

The running sums live on the aggregator's ``device``, and ``finish``
returns tensors there. :class:`QuantizedFedAvgAggregator` folds each
int8 item through the in-place CUDA fold kernel
(:func:`repro_torch.kernels.ops.dequant_accumulate8_into`) on the card,
its plain version on the CPU. :class:`LoRAFedAvgAggregator` folds
low-rank factor pairs and merges them once, in ``finish``.
"""
from __future__ import annotations

import math
import threading
from collections.abc import Callable, Mapping
from typing import Any, Union

import torch

from repro_torch.core.messages import Message
from repro_torch.core.quantization import QuantizedTensor, dequantize, dequantize_batch
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.peft.lowrank import LowRankDelta
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_tensor


class Aggregator:
    """Protocol base: the streaming begin/accept_item/finish surface.

    ``consumes_wire`` declares that the aggregator folds payload items in
    their *wire* form (QuantizedTensor); the job system then builds the
    uplink pipeline with ``decode_values=False``.
    """

    name: str = "aggregator"
    consumes_wire: bool = False

    def weight_of(self, meta: Mapping[str, Any]) -> float:
        """The item weight one contribution's headers imply (pure)."""
        return float(meta.get("num_samples", 1))

    def begin(self, meta: Mapping[str, Any]) -> float:
        """Register one client contribution; returns its item weight."""
        raise NotImplementedError

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        """Fold one payload item of one contribution."""
        raise NotImplementedError

    def finish(self) -> dict[str, Any]:
        """Close the aggregate, reset state, return the result."""
        raise NotImplementedError

    def accept(self, result: Message) -> None:
        """Batch shim: drive the streaming protocol in payload order; the
        contribution is registered only after every item folded."""
        w = self.weight_of(result.headers)
        for name, value in result.payload.items():
            self.accept_item(name, value, w)
        self.begin(result.headers)


class FedAvgAggregator(Aggregator):
    """Sample-weighted incremental FedAvg at original precision."""

    name = "fedavg"

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)
        self._sum: dict[str, torch.Tensor] = {}
        self._weight = 0.0
        self.accepted = 0
        self._lock = threading.Lock()

    def begin(self, meta: Mapping[str, Any]) -> float:
        w = self.weight_of(meta)
        with obs_trace.span("agg.begin", "agg",
                            client=str(meta.get("client", "")), weight=w):
            with self._lock:
                self._weight += w
                self.accepted += 1
        return w

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        """Streaming entry point: one item of one client's result,
        ``sum += value * w`` in fp32 (the reference's arithmetic)."""
        if isinstance(value, QuantizedTensor):
            raise TypeError(
                f"FedAvgAggregator received a quantized item {name!r}; "
                "decode values on the uplink pipeline (the default) or use "
                "QuantizedFedAvgAggregator"
            )
        arr = as_tensor(value, self.device).to(torch.float32)
        w = torch.tensor(weight, dtype=torch.float32, device=self.device)
        with self._lock:
            acc = self._sum.get(name)
            if acc is None:
                self._sum[name] = arr * w
            else:
                acc += arr * w

    def finish(self) -> dict[str, torch.Tensor]:
        with obs_trace.span("agg.finish", "agg"), self._lock:
            if self._weight <= 0:
                raise RuntimeError("no results accepted")
            # divide by a device tensor, not a Python float: a CUDA
            # tensor divided by a host scalar multiplies by its reciprocal
            total = torch.tensor(self._weight, dtype=torch.float32, device=self.device)
            out = {name: arr / total for name, arr in self._sum.items()}
            self._sum = {}
            self._weight = 0.0
            self.accepted = 0
        return out


class QuantizedFedAvgAggregator(Aggregator):
    """Aggregates blockwise8 Task Results directly from int8 payloads —
    the server never materializes K fp32 models. ``accept_item`` is a
    **fused streaming fold**: the item's codes and absmax go to the
    device and the fold kernel updates one fp32 running sum per tensor in
    place (:func:`repro_torch.kernels.ops.dequant_accumulate8_into`), so
    the dequantized contribution never exists as an fp32 tensor.
    Non-quantized (small) items fall back to plain averaging.
    """

    name = "quantized-fedavg"
    consumes_wire = True

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)
        self._acc: dict[str, torch.Tensor] = {}             # running weighted sums
        self._shape: dict[str, tuple[int, ...]] = {}        # orig shapes
        self._plain = FedAvgAggregator(self.device)
        self._plain_names: set[str] = set()
        self._weight = 0.0
        self.accepted = 0
        self._lock = threading.Lock()

    def begin(self, meta: Mapping[str, Any]) -> float:
        w = self.weight_of(meta)
        with obs_trace.span("agg.begin", "agg",
                            client=str(meta.get("client", "")), weight=w):
            with self._lock:
                self._weight += w
                self.accepted += 1
        return w

    def _fold(self, name: str, value: QuantizedTensor, weight: float) -> None:
        q = as_tensor(value.payload, self.device)
        absmax = as_tensor(value.absmax, self.device)
        self._acc[name] = ops.dequant_accumulate8_into(
            self._acc.get(name), q, absmax, weight)

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        if isinstance(value, QuantizedTensor):
            if value.fmt != "blockwise8":
                raise TypeError(
                    f"QuantizedFedAvgAggregator supports blockwise8; {name!r} is {value.fmt}"
                )
            with self._lock:
                known = self._shape.get(name)
                if known is not None and known != tuple(value.orig_shape):
                    raise ValueError(
                        f"contribution for {name!r} has shape "
                        f"{tuple(value.orig_shape)}; aggregate holds {known}"
                    )
                self._shape[name] = tuple(value.orig_shape)
                tr = obs_trace.ACTIVE
                if tr is None:
                    self._fold(name, value, weight)
                else:
                    with tr.span("kernel.dequant_accumulate8", "kernel", item=name,
                                 nbytes=value.payload_bytes):
                        self._fold(name, value, weight)
        else:
            self._plain.accept_item(name, value, weight)
            with self._lock:
                self._plain_names.add(name)

    def finish(self) -> dict[str, torch.Tensor]:
        with obs_trace.span("agg.finish", "agg"), self._lock:
            out: dict[str, torch.Tensor] = {}
            inv = float(torch.tensor(1.0) / torch.tensor(self._weight if self._weight else 1.0))
            for name, acc in self._acc.items():
                shape = self._shape[name]
                n = math.prod(shape)
                # ``inv`` is already an fp32 value, so the scalar multiply
                # rounds once, exactly like the reference's numpy product
                out[name] = acc.reshape(-1)[:n].reshape(shape) * inv
            if self._plain_names:
                # reuse the plain aggregator's running sum (shares self._weight)
                self._plain._weight = self._weight
                out.update(self._plain.finish())
            self._acc = {}
            self._shape = {}
            self._plain_names = set()
            self._weight = 0.0
            self.accepted = 0
        return out


class LoRAFedAvgAggregator(Aggregator):
    """Streams :class:`~repro_torch.peft.lowrank.LowRankDelta`
    contributions into a sample-weighted average without materializing a
    dense per-client delta. ``accept_item`` appends each tensor's factor
    pair, on the device: the left factor scaled by ``weight * alpha/rank``
    (that product taken in float64 and rounded to fp32 once, as the
    reference's ``np.float32(weight * scale)``), the right factor as
    received. Server state during the fold is O(clients * rank * dim).
    ``finish`` merges each tensor once,

    .. math:: (1/W) \\sum_i w_i (\\alpha_i/r_i) A_i B_i
              = \\text{concat}_1(\\tilde A_i) \\cdot \\text{concat}_0(B_i) / W,

    with the factors concatenated along the rank axis in acceptance order
    (ranks and alphas may differ between clients). Other items fold
    through the plain FedAvg, sharing its weight: a ``QuantizedTensor``
    that a ``lora -> quantize`` uplink left quantized is dequantized
    first. ``consumes_wire``: the job builds its uplink undecoded.
    """

    name = "lora-fedavg"
    consumes_wire = True

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)
        self._a: dict[str, list[torch.Tensor]] = {}      # weight-scaled left factors
        self._b: dict[str, list[torch.Tensor]] = {}      # right factors
        self._shape: dict[str, tuple[int, ...]] = {}
        self._plain = FedAvgAggregator(self.device)
        self._plain_names: set[str] = set()
        self._weight = 0.0
        self.accepted = 0
        self._lock = threading.Lock()

    def begin(self, meta: Mapping[str, Any]) -> float:
        w = self.weight_of(meta)
        with obs_trace.span("agg.begin", "agg",
                            client=str(meta.get("client", "")), weight=w):
            with self._lock:
                self._weight += w
                self.accepted += 1
        return w

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        if isinstance(value, LowRankDelta):
            with self._lock:
                known = self._shape.get(name)
                if known is not None and known != tuple(value.orig_shape):
                    raise ValueError(
                        f"contribution for {name!r} has shape "
                        f"{tuple(value.orig_shape)}; aggregate holds {known}"
                    )
                self._shape[name] = tuple(value.orig_shape)
                s = torch.tensor(weight * value.scale, dtype=torch.float32,
                                 device=self.device)
                self._a.setdefault(name, []).append(
                    as_tensor(value.a, self.device).to(torch.float32) * s)
                self._b.setdefault(name, []).append(
                    as_tensor(value.b, self.device).to(torch.float32))
        else:
            if isinstance(value, QuantizedTensor):
                # small tensors a composed lora -> quantize stack left
                # quantized: recover precision, fold through plain FedAvg
                value = dequantize(value, self.device).to(torch.float32)
            self._plain.accept_item(name, value, weight)
            with self._lock:
                self._plain_names.add(name)

    def finish(self) -> dict[str, torch.Tensor]:
        with obs_trace.span("agg.finish", "agg"), self._lock:
            out: dict[str, torch.Tensor] = {}
            inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
                self._weight if self._weight else 1.0, dtype=torch.float32)
            tr = obs_trace.ACTIVE
            for name, a_parts in self._a.items():
                a_cat = torch.cat(a_parts, dim=1)
                b_cat = torch.cat(self._b[name], dim=0)
                if tr is None:
                    dense = ops.low_rank_merge(a_cat, b_cat, inv)
                else:
                    with tr.span("kernel.lora_merge", "kernel", item=name,
                                 rank=int(a_cat.shape[1])):
                        dense = ops.low_rank_merge(a_cat, b_cat, inv)
                out[name] = dense.reshape(self._shape[name])
            if self._plain_names:
                # reuse the plain aggregator's running sum (shares self._weight)
                self._plain._weight = self._weight
                out.update(self._plain.finish())
            self._a = {}
            self._b = {}
            self._shape = {}
            self._plain_names = set()
            self._weight = 0.0
            self.accepted = 0
        return out


class CollectingSink:
    """Protocol-shaped sink that just rebuilds the payload dict; ``finish``
    dequantizes any items still in wire form onto ``device``."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)
        self.payload: dict[str, Any] = {}
        self.meta: dict[str, Any] = {}

    def begin(self, meta: Mapping[str, Any]) -> float:
        self.meta = dict(meta)
        return float(meta.get("num_samples", 1))

    def accept_item(self, name: str, value: Any, weight: float) -> None:
        self.payload[name] = value

    def finish(self) -> dict[str, Any]:
        self.payload = dequantize_batch(self.payload, self.device)
        return self.payload


# ---------------------------------------------------------------------------
# Aggregator registry (the job system resolves "aggregator" names here)
# ---------------------------------------------------------------------------

_AGGREGATORS: dict[str, Callable[..., Aggregator]] = {}

#: aggregator names the reference registers that this package has not
#: ported: none
NOT_PORTED_AGGREGATORS: tuple[str, ...] = ()


def register_aggregator(
    name: str,
) -> Callable[[Callable[..., Aggregator]], Callable[..., Aggregator]]:
    """Decorator binding a spec name to an aggregator factory."""

    def deco(factory: Callable[..., Aggregator]) -> Callable[..., Aggregator]:
        if name in _AGGREGATORS:
            raise ValueError(
                f"aggregator name {name!r} already registered ({_AGGREGATORS[name]})"
            )
        _AGGREGATORS[name] = factory
        return factory

    return deco


def registered_aggregators() -> tuple[str, ...]:
    return tuple(sorted(_AGGREGATORS))


def build_aggregator(spec: Union[str, Mapping[str, Any], Aggregator, None],
                     default: str = "fedavg", device: Any = None) -> Aggregator:
    """``"fedavg"`` | ``{"aggregator": "quantized-fedavg"}`` | instance;
    a built aggregator keeps its sums on ``device``."""
    if spec is None:
        spec = default
    if isinstance(spec, Aggregator):
        return spec
    kwargs: dict[str, Any] = {}
    if isinstance(spec, Mapping):
        kwargs = dict(spec)
        try:
            spec = kwargs.pop("aggregator")
        except KeyError:
            raise ValueError(
                f'aggregator dict spec needs an "aggregator" name key '
                f"(got {sorted(kwargs)}); registered: {registered_aggregators()}"
            ) from None
    try:
        factory = _AGGREGATORS[spec]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {spec!r}; registered: {registered_aggregators()}"
        ) from None
    return factory(device=device, **kwargs)


def aggregator_consumes_wire(
    spec: Union[str, Mapping[str, Any], Aggregator, None],
    default: str = "fedavg",
) -> bool:
    """Whether the aggregator a spec names folds wire-form payload items,
    resolved without instantiating it."""
    if spec is None:
        spec = default
    if isinstance(spec, Aggregator):
        return bool(spec.consumes_wire)
    if isinstance(spec, Mapping):
        spec = spec.get("aggregator", default)
    factory = _AGGREGATORS.get(spec)
    return bool(getattr(factory, "consumes_wire", False))


register_aggregator("fedavg")(FedAvgAggregator)
register_aggregator("quantized-fedavg")(QuantizedFedAvgAggregator)
register_aggregator("lora-fedavg")(LoRAFedAvgAggregator)
