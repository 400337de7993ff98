"""Unified wire pipeline: registry-driven, streaming-aware message transforms.

Mirror of ``src/repro/core/pipeline.py`` — the same envelopes, byte for
byte. A :class:`WirePipeline` is an ordered stack of :class:`Stage`
objects that executes **inside** the streaming loop, so a
container-streamed, quantized upload peaks at ~one item of transmission
memory instead of one model.

Stage hooks, by granularity:

* **whole-message** — ``begin_encode`` (sender, before any item is
  serialized) and ``end_decode`` (receiver, after the payload is
  reassembled).
* **per-item, value level** — ``encode_item`` / ``decode_item`` run on
  each payload tensor around the serialization boundary (quantize /
  dequantize).
* **per-item, byte level** — ``encode_item_bytes`` / ``decode_item_bytes``
  run on each item's serialized bytes (checksums); each application
  records a small metadata dict that travels in the item's wire envelope.

Wire format: when a pipeline has any per-item stage, each item is framed
as a self-describing **envelope**::

    envelope := hlen (u32 LE) | header (utf-8 JSON) | body
    header   := {"kind": "wire", "name": ..., "n": len(body),
                 "v": [value-stage names...],
                 "b": [[byte-stage name, meta], ...]}

A pipeline with no stages frames items exactly like
:func:`repro_torch.core.serialization.serialize_item`. Message headers
cross the wire as a leading ``meta`` item.

Device: a pipeline is bound to one torch device. Quantize encodes build
their fused group there (the CUDA kernel on the card, the plain version
on the CPU) and decodes land there; payload bytes on the wire are numpy.

Ported stages: ``quantize`` (``blockwise8``, ``nf4``, ``fp4``, ``fp16``,
``fp32``, with per-layer rules), ``ef-quantize``, ``adaptive``,
``dp-noise``, ``secure-mask``, ``zlib``, ``crc32`` and ``delta``. The
reference's other stage names (``zstd``, ``topk``, ``lora``) raise
``NotImplementedError`` until ported (ROADMAP A4).

Legacy interop: :func:`legacy_wire_pipelines` adapts the four-point
``Filter``/``FilterChain`` configuration (:mod:`repro_torch.core.filters`)
onto per-hop pipelines via whole-message adapter stages, bitwise
identical to the reference's; the whole transformed payload is
materialized (and metered) before streaming.
"""
from __future__ import annotations

import json
import struct
import zlib as _zlib
from collections.abc import Callable, Iterator, Mapping
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core import secure_agg as sa
from repro_torch.core import serialization as ser
from repro_torch.core.filters import (
    AdaptiveQuantizeFilter,
    DequantizeFilter,
    Filter,
    FilterChain,
    FilterPoint,
    QuantizeFilter,
    SelectiveQuantizeFilter,
    gaussian_noise,
)
from repro_torch.core.messages import Message, MessageKind
from repro_torch.core.quantization import (
    QuantizedTensor,
    check_format,
    dequantize,
    quantize,
    quantize_batch,
)
from repro_torch.core.sparse import SparseTensor
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import mem
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_tensor

_U32 = struct.Struct("<I")

#: reserved item name carrying message kind + headers across the wire
META_ITEM = "__meta__"

#: stage names the reference registers that this package has not ported
NOT_PORTED_STAGES = ("lora", "topk", "zstd")


class WireIntegrityError(ValueError):
    """A byte or stream check rejected an item: a checksum mismatch, a
    compressed stream that does not match its declared length, or a
    desynchronised delta stream."""


class WireContext:
    """Per-message state shared by every stage hook of one transfer.

    ``headers`` is the live header dict of the message being encoded (or
    the transmitted headers on the decode side); ``state`` is stage
    scratch space; ``decode_values`` mirrors the owning pipeline's
    setting; ``vmeta`` is the *current item's* per-stage metadata dict;
    ``device`` is the pipeline's torch device (where quantize runs and
    decoded tensors land).
    """

    __slots__ = ("headers", "state", "decode_values", "vmeta", "device")

    def __init__(self, headers: dict[str, Any], decode_values: bool = True,
                 device: Any = "cpu") -> None:
        self.headers = headers
        self.state: dict[str, Any] = {}
        self.decode_values = decode_values
        self.vmeta: dict[str, Any] = {}
        self.device = torch.device(device)


# ---------------------------------------------------------------------------
# Stage base + registry
# ---------------------------------------------------------------------------

class Stage:
    """One wire transform. Subclass and override any subset of hooks.

    ``name`` is the registry key (set by :func:`register_stage`) and what
    the wire envelope records, so it must be stable across versions.
    ``stateful`` stages (RNG streams, error-feedback residuals, delta
    snapshots) depend on the order of the transfers they see.
    """

    name: str = "stage"
    stateful: bool = False

    # -- whole-message hooks ------------------------------------------------
    def begin_encode(self, message: Message, ctx: WireContext) -> Message:
        return message

    def end_decode(self, message: Message, ctx: WireContext) -> Message:
        return message

    # -- per-item hooks, value level ----------------------------------------
    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        return value

    def decode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        return value

    # -- per-item hooks, byte level -----------------------------------------
    def encode_item_bytes(
        self, name: str, blob: bytes, meta: dict[str, Any], ctx: WireContext
    ) -> bytes:
        return blob

    def decode_item_bytes(
        self, name: str, blob: bytes, meta: Mapping[str, Any], ctx: WireContext
    ) -> bytes:
        return blob

    def encode_item_views(
        self, name: str, views: list, meta: dict[str, Any], ctx: WireContext
    ) -> list:
        """Scatter-gather form of ``encode_item_bytes``: transform an
        ordered list of buffer segments whose concatenation is the item's
        serialized bytes. The default joins only when the subclass
        actually overrides the bytes hook (compat for third-party
        stages); stages that can stream over the segments (checksums)
        override this and never join. Output bytes must equal what
        ``encode_item_bytes`` would produce on the joined input — the
        wire format does not know how the sender held its buffers."""
        if _overrides(self, "encode_item_bytes"):
            return [self.encode_item_bytes(name, ser.join_views(views), meta, ctx)]
        return views

    # -- spec support -------------------------------------------------------
    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> Stage:
        """Build from a job-spec entry; ``arg`` is the ``name:arg`` suffix."""
        if arg is not None:
            raise ValueError(f"stage {cls.name!r} takes no ':arg' (got {arg!r})")
        return cls(**kwargs)

    @classmethod
    def for_decode(cls) -> Stage:
        """A decode-capable instance for receivers that only know the
        stage *name* from a wire envelope (registry fallback). Override
        when ``__init__`` needs encode-side configuration the decode
        hooks don't use."""
        return cls.from_spec(None)


_STAGES: dict[str, type[Stage]] = {}


def register_stage(name: str) -> Callable[[type[Stage]], type[Stage]]:
    """Class decorator: bind ``name`` to a Stage class in the registry."""

    def deco(cls: type[Stage]) -> type[Stage]:
        if name in _STAGES:
            raise ValueError(f"stage name {name!r} already registered ({_STAGES[name]})")
        cls.name = name
        _STAGES[name] = cls
        return cls

    return deco


def registered_stages() -> tuple[str, ...]:
    return tuple(sorted(_STAGES))


StageSpec = Union[str, Mapping[str, Any], Stage]


def build_stage(spec: StageSpec) -> Stage:
    """``"quantize:blockwise8"`` | ``{"stage": "quantize", "fmt": "fp16"}`` | Stage."""
    if isinstance(spec, Stage):
        return spec
    if isinstance(spec, str):
        name, _, arg = spec.partition(":")
        cls = _lookup(name)
        return cls.from_spec(arg or None)
    if isinstance(spec, Mapping):
        kwargs = dict(spec)
        name = kwargs.pop("stage")
        cls = _lookup(name)
        return cls.from_spec(kwargs.pop("arg", None), **kwargs)
    raise TypeError(f"bad stage spec {spec!r}")


def _lookup(name: str) -> type[Stage]:
    try:
        return _STAGES[name]
    except KeyError:
        if name in NOT_PORTED_STAGES:
            raise NotImplementedError(
                f"stage {name!r} is not ported to repro_torch yet (ROADMAP A4); "
                f"ported: {registered_stages()}"
            ) from None
        raise ValueError(
            f"unknown stage {name!r}; registered: {registered_stages()}"
        ) from None


# ---------------------------------------------------------------------------
# Registered stages
# ---------------------------------------------------------------------------

def _is_quantizable(value: Any, min_params: int) -> bool:
    # already-wire-form containers pass through quantize untouched
    if isinstance(value, (QuantizedTensor, SparseTensor)):
        return False
    if isinstance(value, torch.Tensor):
        return bool(value.is_floating_point() and value.numel() >= min_params)
    arr = np.asarray(value)
    return bool(
        np.issubdtype(arr.dtype, np.floating) and int(np.prod(arr.shape)) >= min_params
    )


def _prequantize(stage: Stage, message: Message, ctx: WireContext,
                 fmt_for_name: Callable[[str], Optional[str]],
                 min_params: int) -> None:
    """Batched quantize dispatch (the wire hot path): when ``stage`` is
    the pipeline's first value stage — i.e. its ``encode_item`` inputs
    are exactly the payload items visible here — quantize the whole
    message now, dispatching every tensor's kernel asynchronously and
    blocking once, and park the results for ``encode_item`` to pick up.
    Results are bitwise-identical to the per-item path; only the
    dispatch schedule changes. Falls back silently (per-item quantize in
    the streamer loop) whenever an earlier stage could rewrite items.
    """
    if ctx.state.get("vstage0") is not stage:
        return
    fmt_for = {
        name: fmt for name, value in message.payload.items()
        if (fmt := fmt_for_name(name)) is not None
        and _is_quantizable(value, min_params)
    }
    if not fmt_for:
        return
    pre = quantize_batch(message.payload, fmt_for, ctx.device)
    # keyed by (source value identity): a later whole-message stage may
    # swap the payload, in which case the parked results must not match
    ctx.state[("prequant", id(stage))] = {
        name: (message.payload[name], qt) for name, qt in pre.items()
    }


def _pop_prequant(stage: Stage, name: str, value: Any,
                  ctx: WireContext) -> Optional[QuantizedTensor]:
    pre = ctx.state.get(("prequant", id(stage)))
    if pre is None:
        return None
    ent = pre.get(name)
    if ent is not None and ent[0] is value:
        del pre[name]
        return ent[1]
    return None


@register_stage("quantize")
class QuantizeStage(Stage):
    """Per-item two-way quantization (paper §II-C) — spec ``quantize:nf4``.

    Encode quantizes each float tensor to ``fmt`` as it enters the
    streamer loop; decode recovers original precision item-by-item, so
    neither side ever holds a whole quantized model for transmission.
    Small/integer tensors pass through (same skip rule as the
    reference's legacy ``QuantizeFilter``).

    Per-layer precision: ``rules`` is an ordered
    list of ``(substring, fmt)`` pairs — first matching rule decides the
    tensor's format, ``fmt`` covers the rest, and a rule format of
    ``None`` keeps the tensor at original precision. Spec forms::

        "quantize:nf4"                           # uniform
        "quantize:norm=fp16,embed=keep,nf4"      # rules + default
        {"stage": "quantize", "rules": [["norm", "fp16"], ["embed", null]],
         "fmt": "nf4"}

    (string rules: ``pattern=fmt`` entries, ``=keep``/empty fmt keeps
    original precision, a bare trailing token is the default format).
    """

    def __init__(self, fmt: Optional[str] = None, min_params: int = 0,
                 rules: Optional[list] = None) -> None:
        if not fmt and not rules:
            raise ValueError(
                'quantize stage needs a format and/or rules, e.g. "quantize:blockwise8"'
            )
        self.fmt = fmt
        self.min_params = min_params
        self.rules: list[tuple[str, Optional[str]]] = [
            (str(pat), f) for pat, f in (rules or [])
        ]
        for f in [fmt, *(f for _, f in self.rules)]:
            if f:
                check_format(f)

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> QuantizeStage:
        if arg and "=" in arg:
            rules: list[list[Optional[str]]] = []
            default: Optional[str] = None
            for part in arg.split(","):
                pat, eq, f = part.partition("=")
                if eq:
                    rules.append([pat, None if f in ("", "keep") else f])
                elif default is not None:
                    raise ValueError(
                        f"quantize rules spec {arg!r} names two default "
                        f"formats ({default!r} and {pat!r}); use pattern=fmt "
                        "entries plus at most one bare default"
                    )
                else:
                    default = pat or None
            kwargs.setdefault("fmt", default)
            kwargs.setdefault("rules", rules)
        elif arg:
            kwargs.setdefault("fmt", arg)
        return cls(**kwargs)

    @classmethod
    def for_decode(cls) -> QuantizeStage:
        # decode reads each QuantizedTensor's own fmt; the encode-side
        # format is irrelevant on the receiving end
        return cls("blockwise8")

    def _fmt_for(self, name: str) -> Optional[str]:
        for pat, fmt in self.rules:
            if pat in name:
                return fmt
        return self.fmt

    def _fmt_label(self) -> str:
        if not self.rules:
            return str(self.fmt)
        fmts = {f for _, f in self.rules if f}
        if self.fmt:
            fmts.add(self.fmt)
        return "mixed:" + ",".join(sorted(fmts))

    def begin_encode(self, message: Message, ctx: WireContext) -> Message:
        ctx.headers["quantized_fmt"] = self._fmt_label()
        _prequantize(self, message, ctx, self._fmt_for, self.min_params)
        return message

    def end_decode(self, message: Message, ctx: WireContext) -> Message:
        if ctx.decode_values:
            message.headers.pop("quantized_fmt", None)
        return message

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        pre = _pop_prequant(self, name, value, ctx)
        if pre is not None:
            return pre
        fmt = self._fmt_for(name)
        if fmt is None or not _is_quantizable(value, self.min_params):
            return value
        return quantize(as_tensor(value, ctx.device), fmt)

    def decode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if isinstance(value, QuantizedTensor):
            return dequantize(value, ctx.device)
        return value


@register_stage("ef-quantize")
class ErrorFeedbackQuantizeStage(Stage):
    """Quantize with error feedback (EF-SGD/EF21): transmits
    ``Q(x_t + e_{t-1})`` and keeps the residual per (client, tensor
    name) — one stage instance serves a whole hop direction, and the
    ``client`` header keeps each site's error stream independent (the
    legacy filter keys by name only). Residuals are float32 tensors on
    the pipeline's device. Stateful.
    """

    stateful = True

    def __init__(self, fmt: str, min_params: int = 0) -> None:
        check_format(fmt)
        self.fmt = fmt
        self.min_params = min_params
        self._residual: dict[tuple[str, str], torch.Tensor] = {}

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> ErrorFeedbackQuantizeStage:
        fmt = arg or kwargs.pop("fmt", None)
        if not fmt:
            raise ValueError('ef-quantize stage needs a format, e.g. "ef-quantize:nf4"')
        return cls(fmt, **kwargs)

    @classmethod
    def for_decode(cls) -> ErrorFeedbackQuantizeStage:
        return cls("blockwise8")  # decode reads the wire tensor's own fmt

    def begin_encode(self, message: Message, ctx: WireContext) -> Message:
        ctx.headers["quantized_fmt"] = self.fmt
        ctx.headers["error_feedback"] = True
        return message

    def end_decode(self, message: Message, ctx: WireContext) -> Message:
        if ctx.decode_values:
            message.headers.pop("quantized_fmt", None)
        return message

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if not _is_quantizable(value, self.min_params):
            return value
        key = (str(ctx.headers.get("client", "")), name)
        corrected = _f32(value, ctx.device) + self._residual.get(key, 0.0)
        qt = quantize(corrected, self.fmt)
        self._residual[key] = corrected - dequantize(qt, ctx.device).to(torch.float32)
        return qt

    def decode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if isinstance(value, QuantizedTensor):
            return dequantize(value, ctx.device)
        return value


@register_stage("adaptive")
class AdaptiveQuantizeStage(Stage):
    """Bandwidth-adaptive precision as a pipeline stage: the format is
    chosen once per message in ``begin_encode`` (from the ``client``
    header and the bound per-client link model), then applied item by
    item inside the streamer loop. The decision is the legacy
    :class:`~repro_torch.core.filters.AdaptiveQuantizeFilter`'s.
    """

    def __init__(
        self,
        bandwidth_bps: Optional[float] = None,
        budget_s: float = 1.0,
        min_params: int = 0,
        link_fn: Optional[Callable[[str], float]] = None,
    ) -> None:
        self._decider = AdaptiveQuantizeFilter(
            bandwidth_bps=bandwidth_bps, budget_s=budget_s,
            min_params=min_params, link_fn=link_fn,
        )
        self.min_params = min_params

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> AdaptiveQuantizeStage:
        kwargs.setdefault("bandwidth_bps", float(arg) if arg else 80e6)  # wifi-class
        return cls(**kwargs)

    def bind_network(self, network: Any) -> None:
        self._decider.bind_network(network)

    @property
    def last_fmt_by_client(self) -> dict[str, str]:
        return self._decider.last_fmt_by_client

    def begin_encode(self, message: Message, ctx: WireContext) -> Message:
        fmt = self._decider.fmt_for(message)
        self._decider.last_fmt = fmt
        self._decider.last_fmt_by_client[str(ctx.headers.get("client", ""))] = fmt
        ctx.state["adaptive_fmt"] = fmt
        if fmt != "fp32":
            ctx.headers["quantized_fmt"] = fmt
            _prequantize(self, message, ctx, lambda _name: fmt, self.min_params)
        return message

    def end_decode(self, message: Message, ctx: WireContext) -> Message:
        if ctx.decode_values:
            message.headers.pop("quantized_fmt", None)
        return message

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        pre = _pop_prequant(self, name, value, ctx)
        if pre is not None:
            return pre
        fmt = ctx.state.get("adaptive_fmt", "fp32")
        if fmt == "fp32" or not _is_quantizable(value, self.min_params):
            return value
        return quantize(as_tensor(value, ctx.device), fmt)

    def decode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if isinstance(value, QuantizedTensor):
            return dequantize(value, ctx.device)
        return value


@register_stage("dp-noise")
class DPNoiseStage(Stage):
    """Gaussian-mechanism DP noise, per item, at full precision — stack
    it *before* a quantize stage so noise is added pre-quantization.
    Decode is the identity. Stateful (one RNG stream, drawn in transfer
    and item order).
    """

    stateful = True

    def __init__(self, sigma: float, seed: int = 0) -> None:
        self.sigma = sigma
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> DPNoiseStage:
        if arg is not None:
            kwargs.setdefault("sigma", float(arg))
        return cls(**kwargs)

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if not _is_plain_float(value):
            return value
        return gaussian_noise(self._rng, self.sigma, value)


@register_stage("secure-mask")
class SecureMaskStage(Stage):
    """Pairwise additive masking (Bonawitz-style), per item: fixed-point
    encode plus per-pair mask streams keyed by the ``round`` header, on
    the pipeline's device. Decode is the identity — the server's
    :class:`~repro_torch.core.secure_agg.SecureAggregator` unmasks by
    summation, never per client.
    """

    def __init__(self, client_index: int, all_clients: list[int], base_seed: int = 0) -> None:
        self.client_index = client_index
        self.all_clients = list(all_clients)
        self.base_seed = base_seed

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> SecureMaskStage:
        if arg is not None:
            raise ValueError("secure-mask is configured per client; use dict spec kwargs")
        return cls(**kwargs)

    @classmethod
    def for_decode(cls) -> SecureMaskStage:
        return cls(0, [])  # decode is the identity: masked grids stay masked

    def begin_encode(self, message: Message, ctx: WireContext) -> Message:
        ctx.headers["secure_masked"] = True
        return message

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if not _is_plain_float(value):
            return value
        rnd = int(ctx.headers.get("round", 0))
        return sa.masked_grid(value, self.client_index, self.all_clients,
                              self.base_seed, name, rnd, ctx.device)


@register_stage("zlib")
class ZlibStage(Stage):
    """Byte-level DEFLATE compression of each serialized item — spec
    ``zlib`` or ``zlib:9``. Composes after quantization (quantized
    payloads still compress: absmax metadata and repeated codes)."""

    def __init__(self, level: int = 6) -> None:
        self.level = level

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> ZlibStage:
        if arg is not None:
            kwargs.setdefault("level", int(arg))
        return cls(**kwargs)

    def encode_item_bytes(
        self, name: str, blob: bytes, meta: dict[str, Any], ctx: WireContext
    ) -> bytes:
        meta["n"] = len(blob)
        return _zlib.compress(blob, self.level)

    def encode_item_views(
        self, name: str, views: list, meta: dict[str, Any], ctx: WireContext
    ) -> list:
        # stream the deflate over the segments: bitwise-identical output
        # to one-shot zlib.compress (one zlib stream, one final flush),
        # without first joining the item
        meta["n"] = ser.views_nbytes(views)
        c = _zlib.compressobj(self.level)
        out = [c.compress(seg) for seg in ser.iter_view_segments(views)]
        out.append(c.flush())
        return [b"".join(out)]

    def decode_item_bytes(
        self, name: str, blob: bytes, meta: Mapping[str, Any], ctx: WireContext
    ) -> bytes:
        # the envelope-declared original length bounds decompression, so a
        # corrupted or hostile stream cannot expand past what it declared
        n = meta.get("n")
        if n is None:
            return _zlib.decompress(blob)
        d = _zlib.decompressobj()
        out = d.decompress(blob, int(n))
        if not d.eof or d.unconsumed_tail or len(out) != int(n):
            raise WireIntegrityError(
                f"zlib stream for item {name!r} does not match its declared "
                f"length {n} (got {len(out)} bytes, eof={d.eof})"
            )
        return out


@register_stage("crc32")
class Crc32Stage(Stage):
    """Byte-level integrity check: stamps each item's CRC-32 into the
    envelope metadata; decode recomputes and raises
    :class:`WireIntegrityError` on mismatch."""

    def encode_item_bytes(
        self, name: str, blob: bytes, meta: dict[str, Any], ctx: WireContext
    ) -> bytes:
        meta["crc"] = _zlib.crc32(blob)
        return blob

    def encode_item_views(
        self, name: str, views: list, meta: dict[str, Any], ctx: WireContext
    ) -> list:
        # crc32 streams over the segments incrementally; the item's
        # buffers pass through untouched (the zero-copy integrity path)
        crc = 0
        for seg in ser.iter_view_segments(views):
            crc = _zlib.crc32(seg, crc)
        meta["crc"] = crc
        return views

    def decode_item_bytes(
        self, name: str, blob: bytes, meta: Mapping[str, Any], ctx: WireContext
    ) -> bytes:
        crc = _zlib.crc32(blob)
        if crc != meta.get("crc"):
            raise WireIntegrityError(
                f"crc32 mismatch on item {name!r}: wire carried {meta.get('crc')}, "
                f"received bytes hash to {crc}"
            )
        return blob


def _is_plain_float(value: Any) -> bool:
    if isinstance(value, (QuantizedTensor, SparseTensor)):
        return False
    if isinstance(value, torch.Tensor):
        return value.is_floating_point()
    return bool(np.issubdtype(np.asarray(value).dtype, np.floating))


def _f32(value: Any, device: torch.device) -> torch.Tensor:
    return as_tensor(value, device).to(torch.float32)


def _owned(t: torch.Tensor, source: Any) -> torch.Tensor:
    """``t``, made from ``source``, copied when it may share memory with
    it: received wire buffers may be the sender's own tensors (a
    zero-copy hop), and the port updates parameters in place. A host
    array moved to the card is already a fresh copy."""
    if isinstance(source, torch.Tensor) or t.device.type == "cpu":
        return t.clone()
    return t


@register_stage("delta")
class DeltaStage(Stage):
    """Residual (delta) encoding against the previous round's payload,
    keyed per (client, tensor): transmits ``x_t - x_{t-1}`` so a
    near-converged federation ships near-zero tensors — stack ``zlib``
    after it and the wire cost collapses. Both ends are stateful: the
    encoder keeps the last value it transmitted per key, the decoder the
    last reconstruction — and when one instance serves both ends (the
    in-process wire) the two collapse to **one canonical snapshot** per
    (client, tensor); the envelope's per-item ``vmeta`` records the
    stream position (``d``) and whether the item is a full snapshot
    (``full``, the first transmission per key or a shape change), so a
    desynchronised receiver raises :class:`WireIntegrityError` instead
    of reconstructing garbage.

    Snapshots are float32 tensors on the pipeline's device. Unlike the
    reference's immutable arrays, torch tensors can be updated in place
    (the port's training does so to decoded parameters), so every
    snapshot is a tensor that no caller holds: a full snapshot is copied
    on both ends, and the decoder returns its reconstruction and keeps
    another tensor (the encoder's when they are equal, else a copy).

    Compose with *lossless* downstream stages; after a lossy stage
    (``quantize``) the decoder's reconstruction drifts over rounds.
    Stateful: one transfer at a time (the sequential simulator's order).
    """

    stateful = True

    def __init__(self) -> None:
        self._prev_enc: dict[tuple[str, str], torch.Tensor] = {}
        self._prev_dec: dict[tuple[str, str], torch.Tensor] = {}
        self._seq_enc: dict[tuple[str, str], int] = {}
        self._seq_dec: dict[tuple[str, str], int] = {}

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if not _is_plain_float(value):
            return value
        key = (str(ctx.headers.get("client", "")), name)
        base = self._prev_enc.get(key)
        seq = self._seq_enc.get(key, 0)
        self._seq_enc[key] = seq + 1
        ctx.vmeta["d"] = seq
        arr = _f32(value, ctx.device)
        if base is None or base.shape != arr.shape:
            ctx.vmeta["full"] = 1
            arr = _owned(arr, value)
            self._prev_enc[key] = arr
            return arr
        delta = arr - base
        # track the *decoder's* reconstruction, not the raw stream: both
        # ends stay bit-identical forever and the per-round float32
        # rounding error never accumulates across rounds
        self._prev_enc[key] = base + delta
        return delta

    def decode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if not _is_plain_float(value):
            return value
        key = (str(ctx.headers.get("client", "")), name)
        seq = self._seq_dec.get(key, 0)
        pos = ctx.vmeta.get("d")
        if pos is None or int(pos) != seq:
            raise WireIntegrityError(
                f"delta stream for item {name!r} (client {key[0]!r}) is out "
                f"of sync: wire position {pos}, local position {seq}"
            )
        self._seq_dec[key] = seq + 1
        if ctx.vmeta.get("full"):
            full = _owned(_f32(value, ctx.device), value)
        else:
            base = self._prev_dec.get(key)
            if base is None:
                raise WireIntegrityError(
                    f"delta stream for item {name!r} (client {key[0]!r}) "
                    "carries a residual but no base reconstruction exists "
                    "(missing 'full' snapshot)"
                )
            full = _f32(value, ctx.device) + base
        # one canonical snapshot per (client, tensor): when this same
        # stage instance just encoded this stream position and the stream
        # below delta was lossless, the encoder's tracked reconstruction
        # equals ``full`` — adopt it instead of keeping a second tensor.
        # After a lossy downstream stage the two differ, and the decoder
        # keeps its own, so a shared instance behaves like split ends.
        enc = self._prev_enc.get(key)
        if (enc is not None and self._seq_enc.get(key) == seq + 1
                and enc.shape == full.shape and torch.equal(enc, full)):
            self._prev_dec[key] = enc
        else:
            self._prev_dec[key] = full.clone()
        return full


# ---------------------------------------------------------------------------
# Legacy Filter/FilterChain adapters (deprecated surface)
# ---------------------------------------------------------------------------

def _filter_is_stateful(filt: Filter) -> bool:
    """Whether a legacy filter depends on the order of the transfers it
    sees: an explicit ``stateful`` attribute wins; the known stateless
    built-ins are not; unknown third-party filters are (the conservative
    default)."""
    explicit = getattr(filt, "stateful", None)
    if explicit is not None:
        return bool(explicit)
    return not isinstance(
        filt,
        (QuantizeFilter, DequantizeFilter, SelectiveQuantizeFilter, AdaptiveQuantizeFilter,
         sa.SecureMaskFilter),
    )


class FilterStage(Stage):
    """Adapter: run a legacy egress :class:`~repro_torch.core.filters.Filter`
    as a whole-message hook.

    .. deprecated:: the whole transformed payload is materialized (and
       charged to the :class:`~repro_torch.utils.mem.MemoryMeter`) before
       the streamer sees it. Use a registered per-item stage instead.
    """

    def __init__(self, filt: Filter) -> None:
        self.filter = filt
        self.name = f"filter:{type(filt).__name__}"
        self.stateful = _filter_is_stateful(filt)

    def begin_encode(self, message: Message, ctx: WireContext) -> Message:
        with obs_trace.span(f"stage.encode.{self.name}", "stage"):
            return self.filter.process(message)


class IngressFilterStage(Stage):
    """Adapter: run a legacy ingress Filter (e.g. ``DequantizeFilter``)
    after the payload is reassembled. Same deprecation note as
    :class:`FilterStage`."""

    def __init__(self, filt: Filter) -> None:
        self.filter = filt
        self.name = f"filter:{type(filt).__name__}"
        self.stateful = _filter_is_stateful(filt)

    def end_decode(self, message: Message, ctx: WireContext) -> Message:
        with obs_trace.span(f"stage.decode.{self.name}", "stage"):
            return self.filter.process(message)


def legacy_wire_pipelines(
    server_filters: Mapping[FilterPoint, FilterChain],
    client_filters: Mapping[FilterPoint, FilterChain],
    device: Any = None,
) -> dict[str, WirePipeline]:
    """Map the four-point Filter configuration onto per-hop pipelines on
    ``device``: each hop's egress chain becomes whole-message encode
    stages, the peer's ingress chain whole-message decode stages
    (``end_decode`` hooks run in reverse pipeline order, so the ingress
    wrappers are appended reversed to keep chain order). The filters
    run on their own devices. Results and wire bytes are the
    reference's."""

    def hop(egress: FilterChain, ingress: FilterChain) -> WirePipeline:
        stages: list[Stage] = [FilterStage(f) for f in egress.filters]
        stages += [IngressFilterStage(f) for f in reversed(ingress.filters)]
        return WirePipeline(stages, device=device)

    return {
        "task_data": hop(
            server_filters[FilterPoint.TASK_DATA_OUT],
            client_filters[FilterPoint.TASK_DATA_IN],
        ),
        "task_result": hop(
            client_filters[FilterPoint.TASK_RESULT_OUT],
            server_filters[FilterPoint.TASK_RESULT_IN],
        ),
    }


# ---------------------------------------------------------------------------
# WirePipeline
# ---------------------------------------------------------------------------

def _overrides(stage: Stage, hook: str) -> bool:
    return getattr(type(stage), hook) is not getattr(Stage, hook)


class WirePipeline:
    """An ordered stack of stages bound to one wire hop.

    Encode runs stages first-to-last; decode runs them last-to-first.
    ``decode_values=False`` leaves items in wire form (e.g. quantized
    server-side aggregation consumes :class:`QuantizedTensor` payloads
    directly); byte stages always decode — the items could not be parsed
    otherwise. ``device`` is where quantize runs and decoded tensors
    land; it defaults to CUDA and raises without it.
    """

    def __init__(self, stages: Optional[list[StageSpec]] = None, *,
                 decode_values: bool = True, device: Any = None) -> None:
        self.stages: list[Stage] = [build_stage(s) for s in (stages or [])]
        self.decode_values = decode_values
        self.device = resolve_device(device)
        self._vstages = [s for s in self.stages if _overrides(s, "encode_item")
                         or _overrides(s, "decode_item")]
        self._bstages = [s for s in self.stages if _overrides(s, "encode_item_bytes")
                         or _overrides(s, "decode_item_bytes")
                         or _overrides(s, "encode_item_views")]
        self._by_name = {s.name: s for s in self.stages}

    @property
    def stateful(self) -> bool:
        """Whether any stage depends on the order of the transfers it sees."""
        return any(s.stateful for s in self.stages)

    def __repr__(self) -> str:
        return f"WirePipeline([{', '.join(s.name for s in self.stages)}])"

    # -- encode side --------------------------------------------------------
    def begin_encode(self, message: Message) -> tuple[Message, WireContext]:
        """Run whole-message hooks; returns the message to stream and the
        shared per-transfer context. ``ctx.state['held_bytes']`` is the
        payload size a legacy whole-message transform materialized (0 on
        the per-item path) — the wire charges it to the MemoryMeter for
        the duration of the transfer."""
        ctx = WireContext(message.headers, self.decode_values, self.device)
        original_payload = message.payload
        # the first value stage sees raw payload items, so it may batch
        # whole-message work (async quantize dispatch) in begin_encode
        ctx.state["vstage0"] = self._vstages[0] if self._vstages else None
        for s in self.stages:
            message = s.begin_encode(message, ctx)
            ctx.headers = message.headers
        ctx.state["held_bytes"] = (
            message.payload_bytes() if message.payload is not original_payload else 0
        )
        if META_ITEM in message.payload:
            raise ValueError(f"payload item name {META_ITEM!r} is reserved")
        return message, ctx

    def encode_wire_item_views(self, name: str, value: Any,
                               ctx: WireContext) -> ser.Views:
        """One payload item -> ordered envelope segments (the per-item
        hot path). Payload buffers stay zero-copy views end to end
        unless a byte stage rewrites them (compression)."""
        tr = obs_trace.ACTIVE
        if tr is None:
            vmetas: list[dict[str, Any]] = []
            for s in self._vstages:
                ctx.vmeta = {}
                value = s.encode_item(name, value, ctx)
                vmetas.append(ctx.vmeta)
            inner = ser.serialize_item_views(name, value)
            return self._wrap_views(name, inner, [s.name for s in self._vstages],
                                    ctx, vmetas=vmetas)
        with tr.span("wire.encode_item", "wire", item=name) as sp:
            vmetas = []
            for s in self._vstages:
                ctx.vmeta = {}
                with tr.span(f"stage.encode.{s.name}", "stage", item=name):
                    value = s.encode_item(name, value, ctx)
                vmetas.append(ctx.vmeta)
            inner = ser.serialize_item_views(name, value)
            views = self._wrap_views(name, inner, [s.name for s in self._vstages],
                                     ctx, vmetas=vmetas)
            sp.args["bytes_out"] = ser.views_nbytes(views)
            return views

    def encode_wire_item(self, name: str, value: Any, ctx: WireContext) -> bytes:
        """Joined-bytes form of :meth:`encode_wire_item_views` (compat /
        inspection surface; the streamers use the views directly)."""
        return ser.join_views(self.encode_wire_item_views(name, value, ctx))

    def _wrap_views(self, name: str, inner: ser.Views, vnames: list[str],
                    ctx: WireContext,
                    vmetas: Optional[list[dict[str, Any]]] = None) -> ser.Views:
        if not self._vstages and not self._bstages:
            return inner
        body = inner
        brecs: list[list[Any]] = []
        tr = obs_trace.ACTIVE
        for s in self._bstages:
            bmeta: dict[str, Any] = {}
            if tr is None:
                body = s.encode_item_views(name, body, bmeta, ctx)
            else:
                with tr.span(f"stage.encode.{s.name}", "stage", item=name,
                             bytes_in=ser.views_nbytes(body)) as sp:
                    body = s.encode_item_views(name, body, bmeta, ctx)
                    sp.args["bytes_out"] = ser.views_nbytes(body)
            brecs.append([s.name, bmeta])
        header = {"kind": "wire", "name": name, "n": ser.views_nbytes(body),
                  "v": vnames, "b": brecs}
        if vmetas and any(vmetas):
            # value-stage per-item metadata, aligned with "v"; omitted
            # entirely when no stage wrote any (keeps pre-existing
            # envelopes byte-identical)
            header["vm"] = vmetas
        hb = json.dumps(header, sort_keys=True).encode()
        return [_U32.pack(len(hb)) + hb, *body]

    def _encode_meta(self, message: Message, ctx: WireContext) -> ser.Views:
        body = json.dumps(
            {"kind": message.kind.value, "headers": _json_safe(message.headers)[0]},
            sort_keys=True,
        ).encode()
        header = json.dumps(
            {"kind": "meta", "name": META_ITEM, "n": len(body)}, sort_keys=True
        ).encode()
        inner = [_U32.pack(len(header)) + header + body]
        return self._wrap_views(META_ITEM, inner, [], ctx)

    def iter_encode_views(self, message: Message,
                          ctx: WireContext) -> Iterator[tuple[str, ser.Views]]:
        """Container-streaming producer (the hot path): the meta item,
        then one envelope per payload item, each as scatter-gather
        segments — peak live bytes stays ~one (encoded) item and tensor
        payloads cross the streamer without a single join."""
        views = self._encode_meta(message, ctx)
        with mem.record_hold(ser.views_nbytes(views)):
            yield META_ITEM, views
        for name, value in message.payload.items():
            views = self.encode_wire_item_views(name, value, ctx)
            with mem.record_hold(ser.views_nbytes(views)):
                yield name, views

    def iter_encode(self, message: Message,
                    ctx: WireContext) -> Iterator[tuple[str, bytes]]:
        """Joined-bytes form of :meth:`iter_encode_views` (compat /
        inspection surface — one envelope bytes object per item)."""
        for name, views in self.iter_encode_views(message, ctx):
            yield name, ser.join_views(views)

    def n_items(self, message: Message) -> int:
        return len(message.payload) + 1  # + meta item

    def encode_blob(self, message: Message, ctx: WireContext) -> bytes:
        """Regular-transmission producer: the whole wire message as one
        blob (peak ~ full payload; registered with the MemoryMeter).
        Joins exactly once, at the end, from the per-item segments."""
        parts: list[Any] = [_U32.pack(self.n_items(message))]
        for _, views in self.iter_encode_views(message, ctx):
            parts.extend(views)
        blob = b"".join(parts)
        mem.record_copy(len(blob))
        mem.record_alloc(len(blob))
        return blob

    def unsent_headers(self, message: Message) -> dict[str, Any]:
        """Headers that cannot cross the wire (not JSON-serializable);
        the in-process wire carries them around the transport."""
        return _json_safe(message.headers)[1]

    # -- decode side --------------------------------------------------------
    def decoder(self, sink: Optional[Any] = None) -> WireDecoder:
        """A per-transfer decoder; pass ``sink`` (the streaming-aggregator
        protocol: ``begin(meta) -> weight`` / ``accept_item(name, value,
        weight)``) to fold each decoded item downstream immediately
        instead of collecting a payload dict."""
        return WireDecoder(self, sink=sink)

    def _decode_stage(self, name: str) -> Stage:
        stage = self._by_name.get(name)
        if stage is None:  # receiver without the sender's pipeline: registry default
            stage = _lookup(name).for_decode()
            self._by_name[name] = stage
        return stage

    def decode_wire_item(self, buf: Any, ctx: WireContext) -> tuple[str, Any, int]:
        """Parse one envelope from the head of ``buf`` (any bytes-like —
        receivers hand in a memoryview over their single reassembly
        buffer — or a **list/tuple of segments**: an unjoined
        single-chunk item straight off a scatter-gather hop); returns
        ``(name, value, consumed)``. Body bytes are zero-copy slices and
        decoded arrays are ``frombuffer`` views — only the small JSON
        headers are materialized; a segmented item decodes with zero
        copies unless a field straddles a segment boundary. The meta
        item decodes to its header dict under the reserved name
        ``META_ITEM``."""
        tr = obs_trace.ACTIVE
        if tr is None:
            return self._decode_wire_item(buf, ctx)
        with tr.span("wire.decode_item", "wire") as sp:
            name, value, consumed = self._decode_wire_item(buf, ctx)
            sp.args["item"] = name
            sp.args["bytes_in"] = consumed
            return name, value, consumed

    def _decode_wire_item(self, buf: Any, ctx: WireContext) -> tuple[str, Any, int]:
        if isinstance(buf, (list, tuple)):
            return self._decode_wire_item_segments(buf, ctx)
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        (hlen,) = _U32.unpack_from(mv, 0)
        header = json.loads(bytes(mv[4:4 + hlen]))
        kind = header.get("kind")
        if kind == "wire":
            n = header["n"]
            name = header["name"]
            body: Any = mv[4 + hlen:4 + hlen + n]
            name, value = self._decode_body(name, body, header, ctx)
            return name, value, 4 + hlen + n
        if kind == "meta":
            n = header["n"]
            return META_ITEM, json.loads(bytes(mv[4 + hlen:4 + hlen + n])), 4 + hlen + n
        return ser.deserialize_item(mv)

    def _decode_wire_item_segments(self, segs: Any,
                                   ctx: WireContext) -> tuple[str, Any, int]:
        """Segment-aware envelope parse: the header comes off the leading
        segment and the body stays an unjoined view list when no byte
        stage needs contiguity, so the inner decode is ``frombuffer``
        per segment — the zero-copy receive path."""
        cur = ser.SegmentCursor(segs)
        (hlen,) = _U32.unpack(bytes(cur.read(4)))
        header = json.loads(bytes(cur.read(hlen)))
        kind = header.get("kind")
        if kind == "wire":
            n = header["n"]
            name = header["name"]
            # byte stages (zlib, crc) consume contiguous bytes; without
            # them the body flows through as zero-copy segment views
            body: Any = cur.read(n) if header["b"] else cur.read_views(n)
            name, value = self._decode_body(name, body, header, ctx)
            return name, value, cur.consumed
        if kind == "meta":
            return META_ITEM, json.loads(bytes(cur.read(header["n"]))), cur.consumed
        return ser.deserialize_item(segs)

    def _decode_body(self, name: str, body: Any, header: Mapping[str, Any],
                     ctx: WireContext) -> tuple[str, Any]:
        """Undo byte stages, parse the inner item, undo value stages."""
        tr = obs_trace.ACTIVE
        for sname, bmeta in reversed(header["b"]):
            if tr is None:
                body = self._decode_stage(sname).decode_item_bytes(name, body, bmeta, ctx)
            else:
                with tr.span(f"stage.decode.{sname}", "stage", item=name):
                    body = self._decode_stage(sname).decode_item_bytes(name, body, bmeta, ctx)
        name, value = self._decode_inner(body, ctx)
        if self.decode_values:
            vmetas = header.get("vm") or [{}] * len(header["v"])
            for sname, vmeta in zip(reversed(header["v"]), reversed(vmetas)):
                ctx.vmeta = vmeta
                if tr is None:
                    value = self._decode_stage(sname).decode_item(name, value, ctx)
                else:
                    with tr.span(f"stage.decode.{sname}", "stage", item=name):
                        value = self._decode_stage(sname).decode_item(name, value, ctx)
        return name, value

    def _decode_inner(self, body: Any, ctx: WireContext) -> tuple[str, Any]:
        if isinstance(body, (list, tuple)):
            cur = ser.SegmentCursor(body)
            (hlen,) = _U32.unpack(bytes(cur.read(4)))
            header = json.loads(bytes(cur.read(hlen)))
            if header.get("kind") == "meta":
                return META_ITEM, json.loads(bytes(cur.read(header["n"])))
            name, value, _ = ser.deserialize_item(body)
            return name, value
        mv = body if isinstance(body, memoryview) else memoryview(body)
        (hlen,) = _U32.unpack_from(mv, 0)
        header = json.loads(bytes(mv[4:4 + hlen]))
        if header.get("kind") == "meta":
            n = header["n"]
            return META_ITEM, json.loads(bytes(mv[4 + hlen:4 + hlen + n]))
        name, value, _ = ser.deserialize_item(mv)
        return name, value

    def end_decode(self, message: Message, ctx: WireContext) -> Message:
        for s in reversed(self.stages):
            message = s.end_decode(message, ctx)
        return message


def _value_nbytes(value: Any) -> int:
    """Live bytes of one decoded payload value (QuantizedTensor /
    SparseTensor / array), for metering the streaming-fold hold."""
    total = getattr(value, "total_bytes", None)
    if total is not None:
        return int(total)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    try:
        return int(np.asarray(value).nbytes)
    except (TypeError, ValueError):
        return 0


class WireDecoder:
    """Receiver-side state for one transfer.

    Two consumption modes:

    * **collect** (default): payload items accumulate in ``self.payload``
      and ``finish`` assembles the full Message — the batch path.
    * **sink**: each decoded item is handed to ``sink.accept_item(name,
      value, weight)`` the moment it decodes, then dropped — the item is
      live (and metered) only for the duration of the fold. The leading
      meta item triggers ``sink.begin(headers) -> weight`` first, so the
      sink knows the contribution's sample weight before any tensor
      arrives. ``finish`` then returns a payload-less Message carrying
      the transmitted headers.
    """

    def __init__(self, pipeline: WirePipeline, sink: Optional[Any] = None) -> None:
        self.pipeline = pipeline
        self.ctx = WireContext({}, pipeline.decode_values, pipeline.device)
        self.payload: dict[str, Any] = {}
        self.meta: Optional[dict[str, Any]] = None
        self._sink = sink
        self._sink_weight: Optional[float] = None

    # plugs into ContainerReceiver(decode_item=...); ``buf`` may be an
    # unjoined segment list (zero-copy single-chunk receive)
    def decode_item(self, buf: Any) -> tuple[str, Any, int]:
        return self.pipeline.decode_wire_item(buf, self.ctx)

    # plugs into ContainerReceiver(consume=...)
    def on_item(self, name: str, value: Any) -> None:
        if name == META_ITEM:
            self.meta = value
            self.ctx.headers.update(value.get("headers", {}))
            if self._sink is not None:
                self._sink_weight = float(
                    self._sink.begin(dict(value.get("headers", {})))
                )
        elif self._sink is not None:
            if self._sink_weight is None:
                # no meta item led the stream (bare pre-pipeline wire):
                # open the contribution with what headers we have
                self._sink_weight = float(self._sink.begin(dict(self.ctx.headers)))
            tr = obs_trace.ACTIVE
            if tr is None:
                with mem.record_hold(_value_nbytes(value)):
                    self._sink.accept_item(name, value, self._sink_weight)
            else:
                with tr.span("agg.accept_item", "agg", item=name,
                             nbytes=_value_nbytes(value)):
                    with mem.record_hold(_value_nbytes(value)):
                        self._sink.accept_item(name, value, self._sink_weight)
        else:
            self.payload[name] = value

    # plugs into BlobReceiver(decode_container=...)
    def decode_blob(self, blob: Any) -> dict[str, Any]:
        mv = blob if isinstance(blob, memoryview) else memoryview(blob)
        (n,) = _U32.unpack_from(mv, 0)
        off = 4
        for _ in range(n):
            name, value, consumed = self.decode_item(mv[off:])
            self.on_item(name, value)
            off += consumed
        return self.payload

    def finish(self, fallback_kind: MessageKind,
               local_headers: Optional[Mapping[str, Any]] = None) -> Message:
        """Assemble the received Message and run ``end_decode`` hooks.
        ``local_headers`` are non-wire-safe headers the in-process wire
        carries around the transport; transmitted headers win."""
        headers = dict(local_headers or {})
        kind = fallback_kind
        if self.meta is not None:
            headers.update(self.meta.get("headers", {}))
            kind = MessageKind(self.meta.get("kind", fallback_kind.value))
        msg = Message(kind, self.payload, headers)
        self.ctx.headers = msg.headers
        return self.pipeline.end_decode(msg, self.ctx)


def _json_safe(headers: Mapping[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
    safe: dict[str, Any] = {}
    local: dict[str, Any] = {}
    for k, v in headers.items():
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            local[k] = v
        else:
            safe[k] = v
    return safe, local


def build_pipeline(specs: Optional[list[StageSpec]], *, decode_values: bool = True,
                   device: Any = None) -> WirePipeline:
    """Declarative constructor: ``["quantize:blockwise8", "crc32"]``."""
    return WirePipeline(list(specs or []), decode_values=decode_values, device=device)
