"""Flash-attention forward: the wrapper over the CUDA kernel.

Replaces ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas``). Kernel: ``csrc/flash_attention.cu``
(``flash_fwd_kernel``): an online softmax over K/V tiles held in shared
memory (a ring of cp.async stages), GQA, causal and sliding-window masks
by index arithmetic, 128 query rows a CTA.

Bound on an H100: operations on the tensor cores. The reference computes
in fp32; the kernel keeps fp32 accuracy with a split x = hi + lo: the hi
products as tf32 ``mma.sync`` and both small products in one bf16
``mma.sync`` (twice the depth, at twice the rate), so its least time is
twice that of ``4 * hd`` tf32 operations per visible (query, key) pair.
The bytes of q, k, v and the output are below that at the serving
shapes. The scores never reach device memory.

The reference's kernel is forward-only (it has no custom VJP, and
``jax.grad`` through it fails), and so is this one: the op is a
``torch.autograd.Function`` whose backward raises. For a tensor on the
CPU the wrapper runs the plain version (``ref.attention``); for a CUDA
tensor it launches the kernel or raises. ``flash_attention.launches``
counts its kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: the reference's tile sizes, which its model routes on (``s % 128 == 0``);
#: the kernel's query tile is 128 rows too
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
#: head dims the kernel is built for
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q (B,H,Sq,hd) and k, v (B,KV,Sk,hd) are contiguous,
    16-byte aligned CUDA tensors of one dtype the kernel takes, with
    ``H % KV == 0`` and a head dim it is built for."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-d (B, heads, S, hd), got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, sq, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "in batch or head dim")
    KV, sk = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split into groups of {KV} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    if sk == 0:
        raise ValueError("no keys to attend to")
    if B >= 2**16 or -(-sq // DEFAULT_BLOCK_Q) >= 2**16:
        raise ValueError(f"batch {B} and query tiles ceil({sq} / {DEFAULT_BLOCK_Q}) must each "
                         "be < 65536 (the grid's y, z)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    check_inputs(q, k, v)
    B, H, sq, hd = q.shape
    KV, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, H, KV, sq, sk, hd,
                  int(q.dtype == torch.bfloat16), int(bool(causal)),
                  int(window is not None), 0 if window is None else int(window),
                  1.0 / math.sqrt(hd))
    with _build.count_lock:
        flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel as an autograd op with no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash attention is forward-only: the reference's kernel "
            "(flash_attention_pallas) has no gradient either; train through "
            "the masked-softmax path (models/layers.py::_sdpa)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,hd); k, v: (B,KV,Sk,hd), H % KV == 0 -> (B,H,Sq,hd) in
    q's dtype. Any lengths; the model routes here only at multiples of
    :data:`DEFAULT_BLOCK_Q`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, causal, window)


flash_attention.launches = 0
