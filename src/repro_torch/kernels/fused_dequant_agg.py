"""Streaming fold ``acc <- acc + w * dequant(q)``: wrapper over the CUDA kernel.

Replaces ``src/repro/kernels/fused_dequant_agg.py``
(``dequant_accumulate8_into_pallas``, ``_fold_kernel``). Kernel:
``csrc/blockwise8.cu`` (``fold_kernel``). The K-way
``dequant_accumulate8_pallas`` is not ported yet.

Bound on an H100: device memory — 9 bytes per element (read and write
the fp32 accumulator, read the int8 code) plus 4 bytes of absmax per
4096 elements, for one FMA per element. The kernel updates the caller's
accumulator in place (PyTorch has no buffer donation; the wrapper writes
into ``acc`` and returns it), so a fold allocates nothing and the
dequantized contribution never exists as an fp32 tensor.

For tensors on the CPU the wrapper runs the plain version in ``ref.py``;
for CUDA tensors it launches the kernel or raises. ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.quant_blockwise8 import check_blocks


def dequant_accumulate8_into(
    acc: torch.Tensor, q: torch.Tensor, absmax: torch.Tensor, weight: float
) -> torch.Tensor:
    """acc: (nblocks, 4096) fp32, updated in place and returned;
    q: (nblocks, 4096) int8; absmax: (nblocks,) fp32; weight: scalar."""
    if all(t.device.type == "cpu" for t in (acc, q, absmax)):
        return ref.dequant_accumulate8_into(acc, q, absmax, weight)
    check_blocks(acc, torch.float32, "acc")
    check_blocks(q, torch.int8, "q")
    check_blocks(absmax, torch.float32, "absmax", width=None)
    if not (acc.device == q.device == absmax.device) or not (
            acc.shape == q.shape and absmax.shape[0] == q.shape[0]):
        raise ValueError(
            f"fold operands disagree: acc {tuple(acc.shape)} on {acc.device}, "
            f"q {tuple(q.shape)} on {q.device}, absmax {tuple(absmax.shape)} "
            f"on {absmax.device}"
        )
    if q.shape[0] == 0:
        return acc
    _build.launch("bw8_fold", q.device, acc.data_ptr(), q.data_ptr(),
                  absmax.data_ptr(), float(weight), q.shape[0])
    dequant_accumulate8_into.launches += 1
    return acc


dequant_accumulate8_into.launches = 0
