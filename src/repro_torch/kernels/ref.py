"""Plain PyTorch versions of the kernels.

Each function here is the semantic ground truth for one hand-written
CUDA kernel in ``csrc/blockwise8.cu``, ``csrc/fourbit.cu``,
``csrc/flash_attention.cu`` or ``csrc/slstm_scan.cu``: the wrappers run
it for tensors that lie on the CPU, the CPU tests hold it against the
JAX package's ``ref`` backend (the quantization ops bitwise), and
``chip_smoke.py`` holds each kernel against it on the card.

The arithmetic follows what the JAX reference computes when XLA runs
it, which is not always what its source text says. Every float32 step
flushes subnormals to zero, keeping the sign, on its inputs and on its
result — the reference's XLA CPU build runs with the x86 FTZ and DAZ
modes on (a TPU flushes subnormals too), while PyTorch and the card keep
them, so :func:`ftz` makes the flush explicit:

* quantize: ``scale = 127 / absmax`` is a true (correctly rounded)
  division, ``q = clip(rint(x * scale), -127, 127)``, scale 0 for an
  all-zero block; a zero element of a block whose absmax is below
  ``127 / FLT_MAX`` gets ``0 * inf = NaN``, which both the reference and
  this version encode as 0.
* dequantize: ``q * (absmax * f32(1/127))`` — XLA turns the division by
  127 into a multiply by the rounded reciprocal.
* fold: ``fma(q, absmax * (f32(1/127) * w), acc)`` — one rounding of the
  exact ``q * s + acc``, with the scale reassociated.
* K-way sum: ``acc = 0``, then the fold above for ``k = 0 .. K-1`` in
  order, with ``w_k``. That is what the reference's einsum
  (``kbe,kb->be``) computes under ``jit``, as its collective runs it:
  XLA rewrites ``absmax / 127 * w`` as ``absmax * (f32(1/127) * w)`` and
  contracts over K as a chain of FMAs (probed at K = 1 to 4; evaluated
  eagerly, the einsum divides by 127 instead, and at K = 8 XLA contracts
  in another order — both within a few ulp, see
  ``tests/test_torch_agg.py``).
* 4-bit quantize: ``inv = 1/absmax`` correctly rounded (0 for an
  all-zero block), ``xn = x * inv``, ``rank = sum(xn > mid)`` over the
  15 fp32 midpoints of the sorted codebook, ``idx = perm[rank]``, and
  byte ``j`` of a block is ``idx[2j] << 4 | idx[2j+1]``.
* 4-bit dequantize: ``code[idx] * absmax``, one rounding.

Blocks are rows of a ``(nblocks, BLOCK8)`` or ``(nblocks, BLOCK4)``
view; callers (``ops.py``) flatten and pad arbitrary shapes.

:func:`attention` mirrors the reference's attention oracle
(``src/repro/kernels/ref.py::attention``), the plain version of the
flash-attention kernel, and :func:`slstm_scan` the reference's sLSTM
scan kernel, its final state included; both are held to a tolerance,
not to bits, and neither flushes subnormals.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

BLOCK8 = 4096  # blockwise-int8 block size (bitsandbytes default)
BLOCK4 = 64    # 4-bit block size (bitsandbytes / QLoRA default)

#: the smallest normal float32; anything smaller in magnitude flushes
FLT_MIN = float(np.finfo(np.float32).tiny)

# bitsandbytes FP4 (E2M1-style) codebook, normalized to [-1, 1]
# (the reference's values, bit for bit).
FP4_CODE = np.array(
    [
        0.0, 0.0052083333, 0.6666666667, 1.0,
        0.3333333333, 0.5, 0.1666666667, 0.25,
        -0.0, -0.0052083333, -0.6666666667, -1.0,
        -0.3333333333, -0.5, -0.1666666667, -0.25,
    ],
    dtype=np.float32,
)

# QLoRA NF4 codebook (information-theoretically optimal for N(0,1)).
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

CODEBOOKS = {"fp4": FP4_CODE, "nf4": NF4_CODE}


def _sorted_code_and_perm(code: np.ndarray):
    """Sorted codebook + permutation mapping sorted-rank -> code index.
    The sort is stable, so FP4's ``0.0`` (index 0) ranks before its
    ``-0.0`` (index 8)."""
    order = np.argsort(code, kind="stable")
    return code[order].astype(np.float32), order.astype(np.int32)


def codebook(fmt: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(code, perm, mids)`` of a 4-bit format: the 16-entry fp32
    codebook in index order, the int32 rank -> index permutation, and the
    15 ascending fp32 midpoints of the sorted codebook (formed in
    float32, as the reference forms them)."""
    try:
        code = CODEBOOKS[fmt]
    except KeyError:
        raise ValueError(f"unknown 4-bit format: {fmt!r}") from None
    sorted_code, perm = _sorted_code_and_perm(code)
    mids = ((sorted_code[1:] + sorted_code[:-1]) / np.float32(2.0)).astype(np.float32)
    return code, perm, mids

#: f32(1/127) = 0x1.020408p-7, the reciprocal XLA multiplies by
INV127 = float(np.float32(1.0 / 127.0))


def ftz(t: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to zero, keeping the sign."""
    return torch.where(t.abs() < FLT_MIN, t * 0.0, t)


def _ftz_scalar(v: np.float32) -> float:
    return float(np.copysign(np.float32(0.0), v)) if abs(v) < FLT_MIN else float(v)


def quantize_blockwise8(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nblocks, BLOCK8) float -> (int8 codes, fp32 absmax per block)."""
    x2d = ftz(x2d.to(torch.float32))
    absmax = x2d.abs().amax(dim=-1)
    # tensor / tensor: a correctly rounded division (``127.0 / t`` would
    # be evaluated as ``t.reciprocal() * 127`` and round twice); never
    # subnormal, as absmax <= FLT_MAX
    scale = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax,
                        torch.zeros_like(absmax))
    q = torch.clamp(torch.round(x2d * scale[:, None]), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), absmax


def dequantize_blockwise8(q: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """(nblocks, BLOCK8) int8 + (nblocks,) absmax -> fp32."""
    scale = ftz(ftz(absmax.to(torch.float32)) * INV127)
    return ftz(q.to(torch.float32) * scale[:, None])


def fold_scale(absmax: torch.Tensor, weight: float) -> torch.Tensor:
    """The fold's scale of each block, as XLA compiles the reference's
    ``(absmax / 127.0) * w``: the division becomes a product with
    f32(1/127), and for two blocks or more the scalar constant is
    reassociated with the scalar weight, ``absmax * (f32(1/127) * w)``;
    at one block the constant is a one-element array and the product
    stays ``(absmax * f32(1/127)) * w``. Subnormals flushed at each step."""
    absmax = ftz(absmax.to(torch.float32))
    if absmax.shape[0] == 1:
        return ftz(ftz(absmax * INV127) * _ftz_scalar(np.float32(weight)))
    return ftz(absmax * _ftz_scalar(np.float32(INV127) * np.float32(weight)))


def dequant_accumulate8_into(
    acc: torch.Tensor, q: torch.Tensor, absmax: torch.Tensor, weight: float
) -> torch.Tensor:
    """``acc <- fma(q, absmax * (f32(1/127) * w), acc)``, in place; at one
    block ``acc <- fma(q, (absmax * f32(1/127)) * w, acc)`` (see
    :func:`fold_scale`).

    PyTorch has no elementwise FMA, so the exact ``q * s + acc`` is formed
    in float64 (``q * s`` is exact there: 8 by 24 significant bits) and
    rounded once to float32. The float64 sum is taken with round-to-odd
    (TwoSum's error term decides the last bit), which makes the final
    rounding to float32 equal to a single correct rounding of the exact
    value — the FMA's result, bit for bit (then flushed, if subnormal).
    """
    s = fold_scale(absmax, weight).to(torch.float64)
    p = q.to(torch.float64) * s[:, None]
    a = ftz(acc).to(torch.float64)
    t = p + a
    bp = t - a
    err = (p - bp) + (a - (t - bp))          # exact: p + a == t + err
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(t, float("inf")),
                         torch.full_like(t, float("-inf")))
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    acc.copy_(ftz(t.to(torch.float32)))
    return acc


def dequant_accumulate8(qs: torch.Tensor, absmaxes: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """qs: (K, nblocks, BLOCK8) int8, absmaxes: (K, nblocks), weights: (K,)
    -> (nblocks, BLOCK8) fp32 = sum_k weights[k] * dequant(qs[k]): K folds,
    in order, into a zeroed accumulator."""
    acc = torch.zeros(qs.shape[1:], dtype=torch.float32, device=qs.device)
    for k, w in enumerate(weights.to(torch.float32).tolist()):
        dequant_accumulate8_into(acc, qs[k], absmaxes[k], w)
    return acc


def quantize_4bit(x2d: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nblocks, BLOCK4) float -> ((nblocks, BLOCK4 // 2) packed uint8,
    (nblocks,) fp32 absmax)."""
    _code, perm, mids = codebook(fmt)
    x2d = ftz(x2d.to(torch.float32))
    absmax = x2d.abs().amax(dim=-1)
    # tensor / tensor: a correctly rounded division (``1.0 / t`` would be
    # evaluated as a reciprocal, which may differ in the last bit); it is
    # subnormal, so flushed, for absmax > 2**126
    inv = ftz(torch.where(absmax > 0, torch.ones_like(absmax) / absmax,
                          torch.zeros_like(absmax)))
    xn = ftz(x2d * inv[:, None])
    rank = torch.zeros(xn.shape, dtype=torch.uint8, device=xn.device)
    for m in torch.from_numpy(mids).to(xn.device):   # 15 strict fp32 compares
        rank += xn > m
    # a uint8 index would be read as a mask: gather with int64
    idx = torch.from_numpy(perm).to(device=xn.device, dtype=torch.uint8)[rank.long()]
    del rank
    packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
    return packed, absmax


def dequantize_4bit(packed: torch.Tensor, absmax: torch.Tensor, fmt: str) -> torch.Tensor:
    """(nblocks, BLOCK4 // 2) packed uint8 + (nblocks,) absmax -> (nblocks, BLOCK4) fp32."""
    code = torch.from_numpy(codebook(fmt)[0]).to(packed.device)
    idx = torch.stack([packed >> 4, packed & 0xF], dim=-1).reshape(packed.shape[0], -1)
    return ftz(code[idx.long()] * ftz(absmax.to(torch.float32))[:, None])


#: the mask fill of masked attention scores (finite, as in the reference)
MASK_FILL = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) -> (B,H,Sq,hd) in q's dtype.

    Plain softmax attention in fp32: scores ``q.k / sqrt(hd)``, query head
    ``h`` reading KV head ``h // (H / KV)``; key ``j`` is visible from
    query ``i`` when ``j <= i`` (causal) and ``i - j < window`` (window),
    both indices counted from 0; masked scores are ``-1e30``, so a row
    that sees no key averages every value uniformly, as the reference's."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(torch.float32)) / math.sqrt(hd)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (qi - ki < window)
    s = torch.where(mask, s, MASK_FILL)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    return out.reshape(B, H, Sq, hd).to(q.dtype)


#: the sLSTM state's running max at the start of a sequence
SLSTM_M0 = -1e30


def slstm_scan(gx: torch.Tensor, r: torch.Tensor, num_heads: int
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The sLSTM time recurrence, step by step in fp32.

    gx: (B, S, 4, D) hoisted gate pre-activations in gate order z, i, f,
    o (fp32 or bf16, widened to fp32); r: (4, H, hd, hd) per-head
    recurrent weights, D = H * hd. Returns h (B, S, D) fp32 and the final
    state (c, n, h, m), each (B, H, hd) fp32, from c = n = h = 0 and
    m = -1e30. Each step is the reference kernel's arithmetic
    (``src/repro/kernels/slstm_scan.py``, ``_kernel``): the per-head
    ``h @ r`` added to the gate inputs, then ``tanh``, ``sigmoid`` and
    ``log_sigmoid``, ``m' = max(logf + m, i)``, the two exps, and
    ``h' = o c' / max(n', 1e-6)``."""
    B, S, four, D = gx.shape
    H = num_heads
    hd = D // H
    gx = gx.to(torch.float32)
    # (H, hd_in, gate * hd_out): one product per head gives all four gates
    rr = r.to(torch.float32).permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
    c = torch.zeros((B, H, hd), dtype=torch.float32, device=gx.device)
    n = torch.zeros_like(c)
    h = torch.zeros_like(c)
    m = torch.full_like(c, SLSTM_M0)
    out = gx.new_empty((B, S, D))
    for t in range(S):
        g = gx[:, t].reshape(B, 4, H, hd)
        gh = torch.einsum("bhk,hkl->bhl", h, rr).reshape(B, H, 4, hd)
        z = torch.tanh(g[:, 0] + gh[:, :, 0])
        i_in = g[:, 1] + gh[:, :, 1]
        logf = torch.nn.functional.logsigmoid(g[:, 2] + gh[:, :, 2])
        o = torch.sigmoid(g[:, 3] + gh[:, :, 3])
        m_new = torch.maximum(logf + m, i_in)
        i_s = torch.exp(i_in - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        out[:, t] = h.reshape(B, D)
    return out, (c, n, h, m)
