"""Plain PyTorch versions of the blockwise-int8 kernels.

Each function here is the semantic ground truth for one hand-written
CUDA kernel in ``csrc/blockwise8.cu``: the wrappers run it for tensors
that lie on the CPU, the CPU tests hold it bitwise against the JAX
package's ``ref`` backend, and ``chip_smoke.py`` holds each kernel
against it on the card.

The arithmetic follows what the JAX reference computes when XLA runs
it, which is not always what its source text says:

* quantize: ``scale = 127 / absmax`` is a true (correctly rounded)
  division, ``q = clip(rint(x * scale), -127, 127)``, scale 0 for an
  all-zero block.
* dequantize: ``q * (absmax * f32(1/127))`` — XLA turns the division by
  127 into a multiply by the rounded reciprocal.
* fold: ``fma(q, absmax * (f32(1/127) * w), acc)`` — one rounding of the
  exact ``q * s + acc``, with the scale reassociated.

Blocks are rows of a ``(nblocks, BLOCK8)`` view; callers
(``ops.py``) flatten and pad arbitrary shapes.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK8 = 4096  # blockwise-int8 block size (bitsandbytes default)

#: f32(1/127) = 0x1.020408p-7, the reciprocal XLA multiplies by
INV127 = float(np.float32(1.0 / 127.0))


def quantize_blockwise8(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nblocks, BLOCK8) float -> (int8 codes, fp32 absmax per block)."""
    x2d = x2d.to(torch.float32)
    absmax = x2d.abs().amax(dim=-1)
    # tensor / tensor: a correctly rounded division (``127.0 / t`` would
    # be evaluated as ``t.reciprocal() * 127`` and round twice)
    scale = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax,
                        torch.zeros_like(absmax))
    q = torch.clamp(torch.round(x2d * scale[:, None]), -127, 127).to(torch.int8)
    return q, absmax


def dequantize_blockwise8(q: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """(nblocks, BLOCK8) int8 + (nblocks,) absmax -> fp32."""
    scale = absmax.to(torch.float32) * INV127
    return q.to(torch.float32) * scale[:, None]


def dequant_accumulate8_into(
    acc: torch.Tensor, q: torch.Tensor, absmax: torch.Tensor, weight: float
) -> torch.Tensor:
    """``acc <- fma(q, absmax * (f32(1/127) * w), acc)``, in place.

    PyTorch has no elementwise FMA, so the exact ``q * s + acc`` is formed
    in float64 (``q * s`` is exact there: 8 by 24 significant bits) and
    rounded once to float32. The float64 sum is taken with round-to-odd
    (TwoSum's error term decides the last bit), which makes the final
    rounding to float32 equal to a single correct rounding of the exact
    value — the FMA's result, bit for bit.
    """
    cw = float(np.float32(INV127) * np.float32(weight))
    s = (absmax.to(torch.float32) * cw).to(torch.float64)
    p = q.to(torch.float64) * s[:, None]
    a = acc.to(torch.float64)
    t = p + a
    bp = t - a
    err = (p - bp) + (a - (t - bp))          # exact: p + a == t + err
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(t, float("inf")),
                         torch.full_like(t, float("-inf")))
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    acc.copy_(t)
    return acc
