"""Public quantization ops: arbitrary-shape tensors in, blocked payloads out.

Mirror of ``src/repro/kernels/ops.py`` for the blockwise-int8 and 4-bit
(fp4 / nf4) paths and the K-way int8 sum of the collectives;
:data:`KERNELS` also lists the flash-attention and sLSTM-scan wrappers
(``flash_attention.py``, ``slstm_scan.py``), which the models call
directly. Dispatch is by
device, not by a backend switch: a CUDA tensor runs the hand-written
kernel, a CPU tensor its plain version
(see the wrappers in ``quant_blockwise8.py``, ``quant_nf4.py`` and
``fused_dequant_agg.py``). Both give the same bits. Padding here is wire
padding only — to a whole number of 4096- or 64-element blocks; there is
no TPU grid-row padding.

All ops are asynchronous on CUDA (they enqueue on the current stream);
callers that need host bytes synchronise once per message
(``repro_torch.core.quantization.quantize_batch``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    _build,
    flash_attention,
    fused_dequant_agg,
    quant_blockwise8,
    quant_nf4,
    slstm_scan,
)
from repro_torch.kernels.ref import BLOCK4, BLOCK8

#: every kernel wrapper whose ``launches`` counter a run can read
KERNELS = {
    "quantize_blockwise8": quant_blockwise8.quantize_blockwise8,
    "dequantize_blockwise8": quant_blockwise8.dequantize_blockwise8,
    "dequant_accumulate8_into": fused_dequant_agg.dequant_accumulate8_into,
    "dequant_accumulate8": fused_dequant_agg.dequant_accumulate8,
    "quantize_4bit": quant_nf4.quantize_4bit,
    "dequantize_4bit": quant_nf4.dequantize_4bit,
    "flash_attention": flash_attention.flash_attention,
    "slstm_scan": slstm_scan.slstm_scan,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    with _build.count_lock:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with _build.count_lock:
        for fn in KERNELS.values():
            fn.launches = 0


def pad_to_blocks(x: torch.Tensor, block: int = BLOCK8) -> torch.Tensor:
    """Flatten to fp32 and zero-pad to whole blocks -> (nblocks, block)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    padded = math.ceil(n / block) * block
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat.contiguous().reshape(padded // block, block)


def _unpad(out: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    n = math.prod(shape)
    return out.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def quantize_blockwise8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Any-shape float tensor -> ((nblocks, 4096) int8, (nblocks,) absmax)."""
    return quant_blockwise8.quantize_blockwise8(pad_to_blocks(x))


def dequantize_blockwise8(
    q: torch.Tensor, absmax: torch.Tensor, shape, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Blocked payload -> tensor of ``shape`` (the padding sliced off)."""
    return _unpad(quant_blockwise8.dequantize_blockwise8(q, absmax), shape, dtype)


def quantize_4bit(x: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Any-shape float tensor -> ((nblocks, 32) packed uint8, (nblocks,) absmax)."""
    return quant_nf4.quantize_4bit(pad_to_blocks(x, BLOCK4), fmt)


def dequantize_4bit(
    packed: torch.Tensor, absmax: torch.Tensor, fmt: str, shape,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Packed 4-bit payload -> tensor of ``shape`` (the padding sliced off)."""
    return _unpad(quant_nf4.dequantize_4bit(packed, absmax, fmt), shape, dtype)


def dequant_accumulate8_into(
    acc: torch.Tensor | None, q: torch.Tensor, absmax: torch.Tensor, weight: float
) -> torch.Tensor:
    """Fold one blockwise8 contribution into the running fp32 aggregate,
    in place. ``acc=None`` opens the aggregate (a zeroed accumulator on
    ``q``'s device). ``q``: (nblocks, 4096) int8; ``absmax``: (nblocks,)."""
    if acc is None:
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return fused_dequant_agg.dequant_accumulate8_into(acc, q, absmax, weight)


def dequant_accumulate8(qs: torch.Tensor, absmaxes: torch.Tensor, weights) -> torch.Tensor:
    """Fused K-way dequantize + weighted sum of blockwise8 payloads, summed
    in pod order: ``qs`` (K, nblocks, 4096) int8, ``absmaxes`` (K, nblocks),
    ``weights`` K floats (a tensor, or a sequence put on ``qs``'s device)
    -> (nblocks, 4096) fp32."""
    weights = torch.as_tensor(weights, dtype=torch.float32, device=qs.device)
    return fused_dequant_agg.dequant_accumulate8(qs, absmaxes, weights)


# ---------------------------------------------------------------------------
# low-rank (LoRA) factorization: library calls, not kernels
# ---------------------------------------------------------------------------
# The reference computes both outside any Pallas kernel ("XLA has no
# Pallas-level SVD", src/repro/kernels/ops.py:343-347), so the port takes
# torch's exact SVD (cuSOLVER on the card, LAPACK on the CPU) and
# ``torch.matmul``. Neither has a launch counter or a KERNELS entry.

#: cuSOLVER driver of the card's SVD: ``gesvdj``, the other one torch
#: offers, was faster but not exact on the card (``python3 chip_smoke.py
#: --svd-drivers``, PERF.md §6)
SVD_DRIVER = "gesvd"


def low_rank_decompose(x: torch.Tensor, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(m, n)`` float tensor -> rank-``rank`` factors ``a (m, rank)``,
    ``b (rank, n)`` in fp32 on ``x``'s device, ``a @ b`` the best (Eckart–
    Young) rank-``rank`` approximation of ``x``: the exact thin SVD,
    truncated, the singular values absorbed into ``a``. Each right-factor
    row is flipped so that its first largest-|x| entry is positive (a
    zero entry counts as positive), the reference's canonical signs, so
    one input always gives the same factors."""
    if rank < 1:
        raise ValueError(f"low-rank decompose needs rank >= 1, got {rank}")
    if x.dim() != 2:
        raise ValueError(f"low_rank_decompose takes a 2-D tensor, got shape {tuple(x.shape)}")
    if rank > min(x.shape):
        raise ValueError(f"rank {rank} exceeds min dim of shape {tuple(x.shape)}")
    driver = SVD_DRIVER if x.is_cuda else None
    u, s, vt = torch.linalg.svd(x.to(torch.float32), full_matrices=False, driver=driver)
    u, s, vt = u[:, :rank], s[:rank], vt[:rank, :]
    j = torch.argmax(vt.abs(), dim=1)
    signs = torch.sign(vt[torch.arange(rank, device=vt.device), j])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    a = u * (s * signs)[None, :]
    b = vt * signs[:, None]
    return a.contiguous(), b.contiguous()


def low_rank_merge(a: torch.Tensor, b: torch.Tensor, scale) -> torch.Tensor:
    """``(a @ b) * scale`` in fp32 on ``a``'s device; ``scale`` is rounded
    to fp32 once (a 0-d tensor, as the reference's ``jnp.float32``). Also
    the server's merge of K clients' concatenated factor blocks."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=a.device)
    return (a.to(torch.float32) @ b.to(torch.float32)) * s
