"""Blockwise-int8 quantize / dequantize: wrappers over the CUDA kernels.

Replaces ``src/repro/kernels/quant_blockwise8.py``
(``quantize_blockwise8_pallas`` / ``dequantize_blockwise8_pallas``).
Kernels: ``csrc/blockwise8.cu`` (``quantize_kernel``,
``dequantize_kernel``).

Bound on an H100: device memory. Both move 5 bytes per element (4 of
fp32, 1 of int8, plus 4 bytes of absmax per 4096 elements) for a few
float operations, so the least time is bytes over the HBM rate. The
design streams each 4096-element block once with 16-byte accesses and
keeps the block in registers between the absmax reduction and the
encode; the TPU kernel's ``ROWS = 8`` grid padding does not carry over
(a CTA is one block, so any block count launches as is).

For a tensor on the CPU each wrapper runs the plain version in
``ref.py``; for a CUDA tensor it launches the kernel or raises. Each
wrapper's ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BLOCK8 = ref.BLOCK8


def check_blocks(t: torch.Tensor, dtype: torch.dtype, what: str,
                 width: int | None = BLOCK8) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` shaped (nblocks, width), or (nblocks,) for ``width=None``."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    want = "(nblocks,)" if width is None else f"(nblocks, {width})"
    if t.ndim != (1 if width is None else 2) or (width is not None and t.shape[1] != width):
        raise ValueError(f"{what} must be shaped {want}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
    if t.shape[0] >= 2**31:
        raise ValueError(f"{what} has {t.shape[0]} blocks; the grid takes < 2**31")


def quantize_blockwise8(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nblocks, 4096) fp32 -> ((nblocks, 4096) int8, (nblocks,) absmax)."""
    if x2d.device.type == "cpu":
        return ref.quantize_blockwise8(x2d)
    check_blocks(x2d, torch.float32, "x2d")
    nblocks = x2d.shape[0]
    q = torch.empty((nblocks, BLOCK8), dtype=torch.int8, device=x2d.device)
    absmax = torch.empty((nblocks,), dtype=torch.float32, device=x2d.device)
    if nblocks == 0:
        return q, absmax
    _build.launch("bw8_quantize", x2d.device, x2d.data_ptr(), q.data_ptr(),
                  absmax.data_ptr(), nblocks)
    with _build.count_lock:
        quantize_blockwise8.launches += 1
    return q, absmax


quantize_blockwise8.launches = 0


def dequantize_blockwise8(q: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """(nblocks, 4096) int8 + (nblocks,) fp32 absmax -> (nblocks, 4096) fp32."""
    if q.device.type == "cpu" and absmax.device.type == "cpu":
        return ref.dequantize_blockwise8(q, absmax)
    check_blocks(q, torch.int8, "q")
    check_blocks(absmax, torch.float32, "absmax", width=None)
    if absmax.device != q.device or absmax.shape[0] != q.shape[0]:
        raise ValueError(f"absmax {tuple(absmax.shape)} on {absmax.device} does not "
                         f"match q {tuple(q.shape)} on {q.device}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.shape[0] == 0:
        return out
    _build.launch("bw8_dequantize", q.device, q.data_ptr(), absmax.data_ptr(),
                  out.data_ptr(), q.shape[0])
    with _build.count_lock:
        dequantize_blockwise8.launches += 1
    return out


dequantize_blockwise8.launches = 0
