"""Fused dequantize + weighted sum of int8 payloads: wrappers over the CUDA kernels.

Replaces ``src/repro/kernels/fused_dequant_agg.py``:

* :func:`dequant_accumulate8_into`, the streaming fold
  ``acc <- acc + w * dequant(q)`` (``dequant_accumulate8_into_pallas``,
  ``_fold_kernel``; kernel ``fold_kernel``). Bound on an H100: device
  memory — 9 bytes per element (read and write the fp32 accumulator,
  read the int8 code) plus 4 bytes of absmax per 4096 elements, for one
  FMA per element. The kernel updates the caller's accumulator in place
  (PyTorch has no buffer donation; the wrapper writes into ``acc`` and
  returns it), so a fold allocates nothing and the dequantized
  contribution never exists as an fp32 tensor.
* :func:`dequant_accumulate8`, the K-way ``sum_k w_k * dequant(q_k)``
  over a (K, nblocks, 4096) stack (``dequant_accumulate8_pallas``,
  ``_agg_kernel``; kernel ``agg_kernel``), the cross-pod collective's
  mean. Bound: device memory — K + 4 bytes per element (K codes read,
  the fp32 sum written once) plus 4 K bytes of absmax per 4096 elements.
  The running sum stays in registers across the K pods, so no fp32 copy
  of any pod's payload exists.

Both kernels live in ``csrc/blockwise8.cu``. For tensors on the CPU each
wrapper runs its plain version in ``ref.py``; for CUDA tensors it
launches the kernel or raises. Each wrapper's ``launches`` counts its
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
    with _build.count_lock:
        dequant_accumulate8_into.launches += 1
    return acc


dequant_accumulate8_into.launches = 0


#: the most pods one launch takes: their scales fill at most 48 KiB of
#: shared memory
MAX_PODS = 12288


def dequant_accumulate8(qs: torch.Tensor, absmaxes: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """qs: (K, nblocks, 4096) int8; absmaxes: (K, nblocks) fp32; weights:
    (K,) fp32 -> (nblocks, 4096) fp32 = sum_k weights[k] * dequant(qs[k]),
    summed in the order k = 0 .. K-1."""
    if all(t.device.type == "cpu" for t in (qs, absmaxes, weights)):
        return ref.dequant_accumulate8(qs, absmaxes, weights)
    if qs.ndim != 3 or absmaxes.ndim != 2 or weights.ndim != 1 or not (
            qs.shape[0] == absmaxes.shape[0] == weights.shape[0]
            and qs.shape[1] == absmaxes.shape[1]):
        raise ValueError(
            f"K-way operands disagree: qs {tuple(qs.shape)}, absmaxes "
            f"{tuple(absmaxes.shape)}, weights {tuple(weights.shape)}; expected "
            "(K, nblocks, 4096), (K, nblocks) and (K,)")
    if not (qs.is_contiguous() and absmaxes.is_contiguous() and weights.is_contiguous()):
        raise ValueError("qs, absmaxes and weights must be contiguous")
    k, nblocks = qs.shape[0], qs.shape[1]
    if not 1 <= k <= MAX_PODS:
        raise ValueError(f"K = {k} pods; one launch takes 1 to {MAX_PODS}")
    check_blocks(qs.view(k * nblocks, qs.shape[2]), torch.int8, "qs")
    check_blocks(absmaxes.view(-1), torch.float32, "absmaxes", width=None)
    if weights.dtype != torch.float32:
        raise ValueError(f"weights must be {torch.float32}, got {weights.dtype}")
    if not (qs.device == absmaxes.device == weights.device):
        raise ValueError(f"qs on {qs.device}, absmaxes on {absmaxes.device}, weights on "
                         f"{weights.device}: all must be on one CUDA device")
    if nblocks >= 2**31:
        raise ValueError(f"{nblocks} blocks; the grid takes < 2**31")
    out = torch.empty((nblocks, qs.shape[2]), dtype=torch.float32, device=qs.device)
    if nblocks == 0:
        return out
    _build.launch("bw8_agg", qs.device, qs.data_ptr(), absmaxes.data_ptr(),
                  weights.data_ptr(), out.data_ptr(), k, nblocks)
    with _build.count_lock:
        dequant_accumulate8.launches += 1
    return out


dequant_accumulate8.launches = 0
