"""Public quantization ops: arbitrary-shape tensors in, blocked payloads out.

Mirror of ``src/repro/kernels/ops.py`` for the blockwise-int8 path.
Dispatch is by device, not by a backend switch: a CUDA tensor runs the
hand-written kernel, a CPU tensor its plain version (see the wrappers in
``quant_blockwise8.py`` / ``fused_dequant_agg.py``). Both give the same
bits. Padding here is wire padding only — to a whole number of
4096-element blocks; there is no TPU grid-row padding.

All ops are asynchronous on CUDA (they enqueue on the current stream);
callers that need host bytes synchronise once per message
(``repro_torch.core.quantization.quantize_batch``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import fused_dequant_agg, quant_blockwise8
from repro_torch.kernels.ref import BLOCK8

#: every kernel wrapper whose ``launches`` counter a run can read
KERNELS = {
    "quantize_blockwise8": quant_blockwise8.quantize_blockwise8,
    "dequantize_blockwise8": quant_blockwise8.dequantize_blockwise8,
    "dequant_accumulate8_into": fused_dequant_agg.dequant_accumulate8_into,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def pad_to_blocks(x: torch.Tensor) -> torch.Tensor:
    """Flatten to fp32 and zero-pad to whole blocks -> (nblocks, 4096)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    padded = math.ceil(n / BLOCK8) * BLOCK8
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat.contiguous().reshape(padded // BLOCK8, BLOCK8)


def quantize_blockwise8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Any-shape float tensor -> ((nblocks, 4096) int8, (nblocks,) absmax)."""
    return quant_blockwise8.quantize_blockwise8(pad_to_blocks(x))


def dequantize_blockwise8(
    q: torch.Tensor, absmax: torch.Tensor, shape, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Blocked payload -> tensor of ``shape`` (the padding sliced off)."""
    out = quant_blockwise8.dequantize_blockwise8(q, absmax)
    n = math.prod(shape)
    return out.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def dequant_accumulate8_into(
    acc: torch.Tensor | None, q: torch.Tensor, absmax: torch.Tensor, weight: float
) -> torch.Tensor:
    """Fold one blockwise8 contribution into the running fp32 aggregate,
    in place. ``acc=None`` opens the aggregate (a zeroed accumulator on
    ``q``'s device). ``q``: (nblocks, 4096) int8; ``absmax``: (nblocks,)."""
    if acc is None:
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return fused_dequant_agg.dequant_accumulate8_into(acc, q, absmax, weight)
