"""Message quantization codecs — the paper's §II contribution.

Mirror of ``src/repro/core/quantization.py``. A :class:`QuantizedTensor`
is the wire representation of one parameter tensor. Its payload is a
torch tensor while it stays on the device (:func:`quantize`) and a numpy
array at the wire boundary (:func:`quantize_batch`, and whatever
:mod:`repro_torch.core.serialization` decodes); the bytes are the same.

Formats (paper Table II):

=============  ==========  =====================  ====================
format         payload     meta                   fp32 size
=============  ==========  =====================  ====================
fp16 / bf16    16-bit      —                      50.00 %
blockwise8     int8        fp32 absmax / 4096     25.03 %
fp4 / nf4      4-bit x2/B  fp32 absmax / 64       14.06 %
=============  ==========  =====================  ====================

``fp32`` passes through. ``bf16`` payloads are torch ``bfloat16`` tensors
(the wire names them ``"bfloat16"``, see
:mod:`repro_torch.core.serialization`), cast by bit arithmetic
(:func:`narrow_bf16`, :func:`widen_bf16`) so that every device gives the
reference's bits. Compute is delegated to :mod:`repro_torch.kernels.ops`:
the CUDA kernels for tensors on the card, their plain versions for
tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.trees import as_tensor, numpy_dtype, torch_dtype

FORMATS = ("fp32", "fp16", "bf16", "blockwise8", "fp4", "nf4")
PORTED_FORMATS = FORMATS
_BLOCK_OF = {"blockwise8": 4096, "fp4": 64, "nf4": 64}

Array = Union[np.ndarray, torch.Tensor]


def check_format(fmt: str) -> None:
    """Raise unless ``fmt`` is a known format this package has ported."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r}; valid: {FORMATS}")
    if fmt not in PORTED_FORMATS:
        raise NotImplementedError(
            f"format {fmt!r} is not ported to repro_torch yet (ROADMAP A2); "
            f"ported: {PORTED_FORMATS}"
        )


@dataclasses.dataclass
class QuantizedTensor:
    """Wire format for one tensor: payload + quantization metadata."""

    payload: Array                     # int8 / uint8 (packed 4-bit) / fp16 / bf16 / fp32
    absmax: Optional[Array]            # per-block absmax (blocked formats)
    fmt: str
    orig_shape: tuple[int, ...]
    orig_dtype: Any                    # numpy dtype, as the wire header names it

    # -- accounting (paper Table II) ---------------------------------------
    @staticmethod
    def _nbytes(a: Array) -> int:
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        return int(a.size) * np.dtype(a.dtype).itemsize

    @property
    def payload_bytes(self) -> int:
        return self._nbytes(self.payload)

    @property
    def meta_bytes(self) -> int:
        return 0 if self.absmax is None else self._nbytes(self.absmax)

    @property
    def total_bytes(self) -> int:
        return self.payload_bytes + self.meta_bytes


def _quantize_blocked(x: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    if fmt == "blockwise8":
        return ops.quantize_blockwise8(x)
    return ops.quantize_4bit(x, fmt)


def quantize(x: torch.Tensor, fmt: str) -> QuantizedTensor:
    """One tensor -> QuantizedTensor whose payload stays on ``x``'s device."""
    check_format(fmt)
    shape, dtype = tuple(x.shape), numpy_dtype(x.dtype)
    if fmt == "fp32":
        return QuantizedTensor(x.to(torch.float32), None, fmt, shape, dtype)
    if fmt == "fp16":
        return QuantizedTensor(x.to(torch.float16), None, fmt, shape, dtype)
    if fmt == "bf16":
        return QuantizedTensor(narrow_bf16(x), None, fmt, shape, dtype)
    q, absmax = _quantize_blocked(x, fmt)
    return QuantizedTensor(q, absmax, fmt, shape, dtype)


def widen_fp16(h: torch.Tensor) -> torch.Tensor:
    """fp16 -> fp32 by bit arithmetic on the ``int16`` view, the same bits
    on any device: sign to bit 31; exponent 31 becomes 255 with the
    10-bit payload shifted left by 13 and a NaN quieted (bit 22 set);
    normals rebias the exponent; subnormals (exact in fp32) and zeros as
    IEEE gives them. That is the reference's ``astype`` of a jax fp16
    array. Torch's own CPU cast returns ``0x7fffffff`` for some NaNs
    (its scalar path), and the card's ``cvt`` was never probed."""
    bits = h.view(torch.int16).to(torch.int32) & 0xFFFF
    exp = (bits >> 10) & 0x1F
    man = bits & 0x3FF
    sign = (bits >> 15) << 31                      # int32: wraps to the sign bit
    normal = ((exp + 112) << 23) | (man << 13)
    special = (0xFF << 23) | (man << 13) | ((man != 0).to(torch.int32) << 22)
    tiny = (man.to(torch.float32) * 2.0 ** -24).view(torch.int32)   # zero and subnormals
    out = torch.where(exp == 0x1F, special, torch.where(exp == 0, tiny, normal))
    return (out | sign).view(torch.float32)


def narrow_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 by bit arithmetic on the ``int32`` view, the same bits
    on any device: round to nearest, ties to even, subnormals kept (the
    reference's ``astype`` does not flush here), overflow to ±inf, and
    every NaN to ``sign | 0x7fc0`` — the reference's quiet NaN. Torch's
    own CPU cast gives ``0xffff`` for a NaN."""
    bits = x.to(torch.float32).view(torch.int32)
    # the carry of round-half-to-even; no finite or infinite input
    # overflows int32 here (the largest, 0x7f800000 + 0x8000, is < 2^31)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    nan = (bits >> 16) & -0x8000 | 0x7FC0          # sign | quiet NaN
    out = torch.where(torch.isnan(x), nan, rounded)
    return out.to(torch.int16).view(torch.bfloat16)


def widen_bf16(h: torch.Tensor) -> torch.Tensor:
    """bf16 -> fp32 as ``bits << 16``, the same on any device: NaN
    payloads and subnormals kept, as every package's cast does."""
    return (h.view(torch.int16).to(torch.int32) << 16).view(torch.float32)


def dequantize(qt: QuantizedTensor, device: Any) -> torch.Tensor:
    """QuantizedTensor -> tensor of its original shape and dtype on ``device``."""
    check_format(qt.fmt)
    dtype = torch_dtype(qt.orig_dtype)
    if qt.fmt not in _BLOCK_OF:
        payload = as_tensor(qt.payload, device)
        if payload.dtype == torch.float16 and dtype != torch.float16:
            payload = widen_fp16(payload)
        elif payload.dtype == torch.bfloat16 and dtype != torch.bfloat16:
            payload = widen_bf16(payload)
        return payload.to(dtype).reshape(qt.orig_shape)
    payload, absmax = as_tensor(qt.payload, device), as_tensor(qt.absmax, device)
    if qt.fmt == "blockwise8":
        return ops.dequantize_blockwise8(payload, absmax, qt.orig_shape, dtype)
    return ops.dequantize_4bit(payload, absmax, qt.fmt, qt.orig_shape, dtype)


# ---------------------------------------------------------------------------
# state-dict level (what the filters and the wire stages transform)
# ---------------------------------------------------------------------------

def quantize_state_dict(sd: Mapping[str, Any], fmt: str,
                        device: Any) -> dict[str, QuantizedTensor]:
    """Per item, as the reference's: each tensor is one :func:`quantize`
    call on ``device`` (one kernel launch per blocked item on the card),
    and its payload stays there."""
    device = torch.device(device)
    return {name: quantize(as_tensor(arr, device), fmt) for name, arr in sd.items()}


def dequantize_state_dict(qsd: Mapping[str, QuantizedTensor],
                          device: Any) -> dict[str, torch.Tensor]:
    """Per item: each QuantizedTensor is one :func:`dequantize` call onto
    ``device``."""
    device = torch.device(device)
    return {name: dequantize(qt, device) for name, qt in qsd.items()}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, through pinned memory on CUDA (the caller
    synchronises once for the whole group)."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host.numpy()


def pack_group(
    items: Mapping[str, Any], names: list[str], device: torch.device, block: int
) -> tuple[torch.Tensor, list[tuple[str, tuple[int, ...], np.dtype, int, int]]]:
    """The fused group's layout: every tensor of ``names`` padded to whole
    ``block``-element blocks (exactly the per-tensor wire layout) and laid
    back to back in one ``(nblocks, block)`` fp32 buffer **on the
    device**. Returns the buffer and, per tensor, ``(name, shape, dtype,
    first block, blocks)``. Block boundaries never span tensors."""
    spans: list[tuple[str, tuple[int, ...], np.dtype, int, int]] = []
    total = 0
    for name in names:
        value = items[name]
        nb = math.ceil(math.prod(value.shape) / block)
        dtype = numpy_dtype(value.dtype) if isinstance(value, torch.Tensor) \
            else np.asarray(value).dtype
        spans.append((name, tuple(value.shape), dtype, total, nb))
        total += nb
    big = torch.zeros(total * block, dtype=torch.float32, device=device)
    for name, shape, _dtype, start, _nb in spans:
        n = math.prod(shape)
        big[start * block: start * block + n].copy_(
            as_tensor(items[name], device).reshape(-1))
    return big.view(total, block), spans


def _fused_quantize_group(
    items: Mapping[str, Any], names: list[str], fmt: str, device: torch.device
) -> dict[str, QuantizedTensor]:
    """One kernel launch for a whole format group laid out by
    :func:`pack_group`; each tensor's payload/absmax are row slices of
    the single result, bitwise-identical to quantizing each tensor
    alone.

    The codes leave the device in one copy into pinned host memory, at
    the one synchronisation point per group; the payloads are numpy views
    of it (they keep the pinned buffer alive)."""
    big, spans = pack_group(items, names, device, _BLOCK_OF[fmt])
    q, am = _quantize_blocked(big, fmt)
    del big
    q_np, am_np = _to_host(q), _to_host(am)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()   # the one sync point
    return {
        name: QuantizedTensor(q_np[start:start + nb], am_np[start:start + nb],
                              fmt, shape, dtype)
        for name, shape, dtype, start, nb in spans
    }


def quantize_batch(
    items: Mapping[str, Any], fmt_for: Mapping[str, str], device: Any
) -> dict[str, QuantizedTensor]:
    """Whole-message quantization: one kernel launch per format group
    (all same-format tensors concatenated block-aligned on ``device``),
    one device-to-host copy and sync per group. ``fmt_for`` maps item
    name -> format; items absent from it are skipped. Results are
    bitwise-identical to calling :func:`quantize` per item, with numpy
    payloads (the wire form)."""
    device = torch.device(device)
    out: dict[str, QuantizedTensor] = {}
    groups: dict[str, list[str]] = {}
    for name, value in items.items():
        fmt = fmt_for.get(name)
        if fmt is None:
            continue
        check_format(fmt)
        if fmt in _BLOCK_OF:
            groups.setdefault(fmt, []).append(name)
        else:  # fp32/fp16/bf16 casts: cheap per-tensor work
            qt = quantize(as_tensor(value, device), fmt)
            qt.payload = qt.payload.cpu()
            if fmt != "bf16":   # numpy has no bfloat16: bf16 stays a CPU tensor
                qt.payload = qt.payload.numpy()
            out[name] = qt
    for fmt, names in groups.items():
        with obs_trace.span("kernel.quantize_batch", "kernel", fmt=fmt, items=len(names)):
            out.update(_fused_quantize_group(items, names, fmt, device))
    return out


def dequantize_batch(items: Mapping[str, Any], device: Any) -> dict[str, Any]:
    """Whole-message dequantization: QuantizedTensor items become tensors
    on ``device`` (one kernel launch per item), other items pass through.
    The per-group fusion of the reference waits for a later slice; the
    results are the same bits either way."""
    return {
        name: dequantize(value, device) if isinstance(value, QuantizedTensor) else value
        for name, value in items.items()
    }


def message_size_report(sd: Mapping[str, Any], fmt: str) -> dict[str, float]:
    """Byte accounting for one message under ``fmt`` **without** running
    the quantizer — pure arithmetic over shapes (paper Table II)."""
    mb = 1024.0 * 1024.0
    n_params = sum(math.prod(a.shape) for a in sd.values())
    fp32_bytes = 4.0 * n_params
    if fmt == "fp32":
        payload, meta = fp32_bytes, 0.0
    elif fmt in ("fp16", "bf16"):
        payload, meta = 2.0 * n_params, 0.0
    elif fmt == "blockwise8":
        payload = 1.0 * n_params
        # absmax per 4096-block + bitsandbytes' per-tensor 256-entry fp32
        # dynamic code map (1 KiB), as the reference counts it
        meta = 4.0 * sum(math.ceil(math.prod(a.shape) / 4096) for a in sd.values())
        meta += 1024.0 * len(sd)
    elif fmt in ("fp4", "nf4"):
        payload = 0.5 * n_params
        meta = 4.0 * sum(math.ceil(math.prod(a.shape) / 64) for a in sd.values())
    else:
        raise ValueError(fmt)
    return {
        "format": fmt,
        "model_mb": payload / mb,
        "meta_mb": meta / mb,
        "total_mb": (payload + meta) / mb,
        "fp32_pct": 100.0 * (payload + meta) / fp32_bytes,
    }
