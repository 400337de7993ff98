"""Plain PyTorch reference of the wire codecs and the server's fold.

The formats are those of the paper's Table II, as the configuration's
traffic names them:

* ``blockwise8``: blocks of 4096 elements of the flattened tensor (the
  last one padded with zeros); ``absmax`` per block;
  ``q = clamp(rint(x * (127 / absmax)), -127, 127)`` with the division
  correctly rounded, 0 for an all-zero block; decoded as
  ``q * (absmax * f32(1/127))``.
* ``nf4``: blocks of 64; ``xn = x * (1 / absmax)``; the code is the
  NF4 entry whose interval between the sorted codebook's midpoints holds
  ``xn``; two codes a byte, the first in the high nibble; decoded as
  ``code * absmax``.

Float32 subnormals are flushed to zero, sign kept, on every step's input
and result, as the codecs define it. The fold is computed in float64:
``sum_k w_k * decode(q_k) / sum_k w_k``.
"""
from __future__ import annotations

import torch

BLOCK = {"blockwise8": 4096, "nf4": 64}
FLT_MIN = 1.1754943508222875e-38
INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

NF4 = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


def ftz(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t.abs() < FLT_MIN, t * 0.0, t)


def blocks(flat: torch.Tensor, fmt: str) -> torch.Tensor:
    """A flat float tensor, zero-padded to whole blocks, as (nblocks, block)."""
    b = BLOCK[fmt]
    n = flat.numel()
    pad = (-n) % b
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, b)


def encode(x2d: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(nblocks, block) float32 -> (codes, absmax). blockwise8 codes are
    int8 (nblocks, 4096); nf4 codes are packed uint8 (nblocks, 32)."""
    x2d = ftz(x2d.to(torch.float32))
    absmax = x2d.abs().amax(dim=-1)
    if fmt == "blockwise8":
        scale = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax,
                            torch.zeros_like(absmax))
        q = torch.clamp(torch.round(x2d * scale[:, None]), -127, 127)
        return torch.nan_to_num(q, nan=0.0).to(torch.int8), absmax
    if fmt != "nf4":
        raise ValueError(f"unknown format {fmt!r}")
    code = torch.tensor(NF4, dtype=torch.float32, device=x2d.device)
    mids = (code[1:] + code[:-1]) / 2.0          # NF4 is sorted ascending
    inv = ftz(torch.where(absmax > 0, torch.ones_like(absmax) / absmax,
                          torch.zeros_like(absmax)))
    xn = ftz(x2d * inv[:, None])
    idx = torch.bucketize(xn, mids, right=False).to(torch.uint8)   # count of mids < xn
    return (idx[:, 0::2] << 4) | idx[:, 1::2], absmax


def decode(codes: torch.Tensor, absmax: torch.Tensor, fmt: str) -> torch.Tensor:
    """(codes, absmax) -> (nblocks, block) float32."""
    if fmt == "blockwise8":
        scale = ftz(ftz(absmax.to(torch.float32)) * INV127)
        return ftz(codes.to(torch.float32) * scale[:, None])
    code = torch.tensor(NF4, dtype=torch.float32, device=codes.device)
    idx = torch.stack([codes >> 4, codes & 0xF], dim=-1).reshape(codes.shape[0], -1)
    return ftz(code[idx.long()] * ftz(absmax.to(torch.float32))[:, None])


def roundtrip(flat: torch.Tensor, fmt: str) -> torch.Tensor:
    """A flat float32 tensor through the codec and back, same length."""
    n = flat.numel()
    return decode(*encode(blocks(flat, fmt), fmt), fmt).reshape(-1)[:n]


def fold(values: list[torch.Tensor], weights: list[float]) -> torch.Tensor:
    """The weighted mean of decoded contributions, in float64."""
    total = sum(weights)
    acc = torch.zeros_like(values[0], dtype=torch.float64)
    for v, w in zip(values, weights):
        acc += v.to(torch.float64) * w
    return acc / total
