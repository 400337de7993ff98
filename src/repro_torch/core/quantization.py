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
fp16           16-bit      —                      50.00 %
blockwise8     int8        fp32 absmax / 4096     25.03 %
=============  ==========  =====================  ====================

``fp32`` passes through. ``bf16`` needs a numpy bfloat16 on the wire and
``fp4`` / ``nf4`` need the 4-bit kernels (ROADMAP B4/B5); all three raise
``NotImplementedError`` here until ported. Compute is delegated to
:mod:`repro_torch.kernels.ops`: the CUDA kernels for tensors on the card,
their plain versions for tensors on the CPU.
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
PORTED_FORMATS = ("fp32", "fp16", "blockwise8")
_BLOCK_OF = {"blockwise8": 4096}

Array = Union[np.ndarray, torch.Tensor]


def check_format(fmt: str) -> None:
    """Raise unless ``fmt`` is a known format this package has ported."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r}; valid: {FORMATS}")
    if fmt not in PORTED_FORMATS:
        raise NotImplementedError(
            f"format {fmt!r} is not ported to repro_torch yet (ROADMAP A2/B4/B5); "
            f"ported: {PORTED_FORMATS}"
        )


@dataclasses.dataclass
class QuantizedTensor:
    """Wire format for one tensor: payload + quantization metadata."""

    payload: Array                     # int8 / fp16 / fp32
    absmax: Optional[Array]            # per-block absmax (blockwise8)
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


def quantize(x: torch.Tensor, fmt: str) -> QuantizedTensor:
    """One tensor -> QuantizedTensor whose payload stays on ``x``'s device."""
    check_format(fmt)
    shape, dtype = tuple(x.shape), numpy_dtype(x.dtype)
    if fmt == "fp32":
        return QuantizedTensor(x.to(torch.float32), None, fmt, shape, dtype)
    if fmt == "fp16":
        return QuantizedTensor(x.to(torch.float16), None, fmt, shape, dtype)
    q, absmax = ops.quantize_blockwise8(x)
    return QuantizedTensor(q, absmax, fmt, shape, dtype)


def dequantize(qt: QuantizedTensor, device: Any) -> torch.Tensor:
    """QuantizedTensor -> tensor of its original shape and dtype on ``device``."""
    check_format(qt.fmt)
    dtype = torch_dtype(qt.orig_dtype)
    if qt.fmt != "blockwise8":
        return as_tensor(qt.payload, device).to(dtype).reshape(qt.orig_shape)
    return ops.dequantize_blockwise8(
        as_tensor(qt.payload, device), as_tensor(qt.absmax, device),
        qt.orig_shape, dtype,
    )


# ---------------------------------------------------------------------------
# state-dict level (what the wire stages transform)
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, through pinned memory on CUDA (the caller
    synchronises once for the whole group)."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host.numpy()


def pack_blockwise8_group(
    items: Mapping[str, Any], names: list[str], device: torch.device
) -> tuple[torch.Tensor, list[tuple[str, tuple[int, ...], np.dtype, int, int]]]:
    """The fused group's layout: every tensor of ``names`` padded to whole
    blocks (exactly the per-tensor wire layout) and laid back to back in
    one ``(nblocks, BLOCK8)`` fp32 buffer **on the device**. Returns the
    buffer and, per tensor, ``(name, shape, dtype, first block, blocks)``.
    Block boundaries never span tensors."""
    block = _BLOCK_OF["blockwise8"]
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
    items: Mapping[str, Any], names: list[str], device: torch.device
) -> dict[str, QuantizedTensor]:
    """One kernel launch for a whole blockwise8 group laid out by
    :func:`pack_blockwise8_group`; each tensor's payload/absmax are row
    slices of the single result, bitwise-identical to quantizing each
    tensor alone.

    The codes leave the device in one copy into pinned host memory, at
    the one synchronisation point per group; the payloads are numpy views
    of it (they keep the pinned buffer alive)."""
    big, spans = pack_blockwise8_group(items, names, device)
    q, am = ops.quantize_blockwise8(big)
    del big
    q_np, am_np = _to_host(q), _to_host(am)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()   # the one sync point
    return {
        name: QuantizedTensor(q_np[start:start + nb], am_np[start:start + nb],
                              "blockwise8", shape, dtype)
        for name, shape, dtype, start, nb in spans
    }


def quantize_batch(
    items: Mapping[str, Any], fmt_for: Mapping[str, str], device: Any
) -> dict[str, QuantizedTensor]:
    """Whole-message quantization: one kernel launch per blockwise8
    group (all such tensors concatenated block-aligned on ``device``),
    one device-to-host copy and sync per message. ``fmt_for`` maps item
    name -> format; items absent from it are skipped. Results are
    bitwise-identical to calling :func:`quantize` per item, with numpy
    payloads (the wire form)."""
    device = torch.device(device)
    out: dict[str, QuantizedTensor] = {}
    names: list[str] = []
    for name, value in items.items():
        fmt = fmt_for.get(name)
        if fmt is None:
            continue
        check_format(fmt)
        if fmt in _BLOCK_OF:
            names.append(name)
        else:  # fp32/fp16 casts: cheap per-tensor work
            qt = quantize(as_tensor(value, device), fmt)
            qt.payload = qt.payload.cpu().numpy()
            out[name] = qt
    if names:
        with obs_trace.span("kernel.quantize_batch", "kernel", fmt="blockwise8",
                            items=len(names)):
            out.update(_fused_quantize_group(items, names, device))
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
