"""4-bit codebook quantize / dequantize (fp4 / nf4): wrappers over the CUDA kernels.

Replaces ``src/repro/kernels/quant_nf4.py`` (``quantize_4bit_pallas`` /
``dequantize_4bit_pallas``). Kernels: ``csrc/fourbit.cu``
(``quantize4_kernel``, ``dequantize4_kernel``), parametrised by the
format's codebook, its rank -> index permutation and its 15 fp32
midpoints, which the wrapper hands over from :func:`ref.codebook`.

Bound on an H100: device memory. Quantize moves 4.5 bytes per element
(4 of fp32 in, half a byte of packed codes out) plus 4 bytes of absmax
per 64 elements, dequantize the same the other way round, for a few
float operations and 15 compares per element. The TPU kernel's
``ROWS4 = 256`` grid padding does not carry over: a half-warp is one
block, so any block count launches as is.

For a tensor on the CPU each wrapper runs the plain version in
``ref.py``; for a CUDA tensor it launches the kernel or raises. Each
wrapper's ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.quant_blockwise8 import check_blocks

BLOCK4 = ref.BLOCK4


@functools.lru_cache(maxsize=None)
def _host_codebook(fmt: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous host copies of ``ref.codebook(fmt)`` whose addresses the
    C entry points read at launch (kept alive by the cache)."""
    code, perm, mids = ref.codebook(fmt)
    return (np.ascontiguousarray(code, np.float32), np.ascontiguousarray(mids, np.float32),
            np.ascontiguousarray(perm, np.int32))


def _launch(name: str, fmt: str, device: torch.device, *args) -> None:
    code, mids, perm = _host_codebook(fmt)
    _build.launch(name, device, *args, code.ctypes.data, mids.ctypes.data,
                  perm.ctypes.data)


def quantize_4bit(x2d: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nblocks, 64) fp32 -> ((nblocks, 32) packed uint8, (nblocks,) absmax)."""
    if x2d.device.type == "cpu":
        return ref.quantize_4bit(x2d, fmt)
    ref.codebook(fmt)   # raises on an unknown format
    check_blocks(x2d, torch.float32, "x2d", width=BLOCK4)
    nblocks = x2d.shape[0]
    packed = torch.empty((nblocks, BLOCK4 // 2), dtype=torch.uint8, device=x2d.device)
    absmax = torch.empty((nblocks,), dtype=torch.float32, device=x2d.device)
    if nblocks == 0:
        return packed, absmax
    _launch("fb4_quantize", fmt, x2d.device, x2d.data_ptr(), packed.data_ptr(),
            absmax.data_ptr(), nblocks)
    quantize_4bit.launches += 1
    return packed, absmax


quantize_4bit.launches = 0


def dequantize_4bit(packed: torch.Tensor, absmax: torch.Tensor, fmt: str) -> torch.Tensor:
    """(nblocks, 32) packed uint8 + (nblocks,) fp32 absmax -> (nblocks, 64) fp32."""
    if packed.device.type == "cpu" and absmax.device.type == "cpu":
        return ref.dequantize_4bit(packed, absmax, fmt)
    ref.codebook(fmt)
    check_blocks(packed, torch.uint8, "packed", width=BLOCK4 // 2)
    check_blocks(absmax, torch.float32, "absmax", width=None)
    if absmax.device != packed.device or absmax.shape[0] != packed.shape[0]:
        raise ValueError(f"absmax {tuple(absmax.shape)} on {absmax.device} does not "
                         f"match packed {tuple(packed.shape)} on {packed.device}")
    out = torch.empty((packed.shape[0], BLOCK4), dtype=torch.float32, device=packed.device)
    if packed.shape[0] == 0:
        return out
    _launch("fb4_dequantize", fmt, packed.device, packed.data_ptr(), absmax.data_ptr(),
            out.data_ptr(), packed.shape[0])
    dequantize_4bit.launches += 1
    return out


dequantize_4bit.launches = 0
