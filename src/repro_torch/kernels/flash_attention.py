"""Flash-attention forward: the wrapper over the CUDA kernel.

Replaces ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas``). Kernel: ``csrc/flash_attention.cu``
(``flash_fwd_kernel`` at head dims 64 and 128): an online softmax over K/V
tiles held in shared memory (a ring of cp.async stages), GQA, causal and
sliding-window masks by index arithmetic, 128 query rows a CTA. Head dims
96 and 256 (phi-3-vision, recurrentgemma) take ``flash_wide_kernel`` in
the same source: the same function and arithmetic, 8 warps a CTA with Q
in registers, a pair of warps sharing each block of 16 query rows at hd
256 (each half of the columns), and a ring of 3 K/V stages split once as
they land. :func:`layout` gives each kernel's shape; the CUDA source
recomputes it and refuses any other.

Bound on an H100: operations on the tensor cores. The reference computes
in fp32; the kernel keeps fp32 accuracy with a split x = hi + lo: the hi
products as tf32 ``mma.sync`` and both small products in one bf16
``mma.sync`` (twice the depth, at twice the rate), so its least time is
twice that of ``4 * hd`` tf32 operations per visible (query, key) pair.
The bytes of q, k, v and the output are below that at the serving
shapes. The scores never reach device memory.

The reference's kernel is forward-only (it has no custom VJP, and
``jax.grad`` through it fails), and so is this one: the op is a
``torch.autograd.Function`` whose backward raises. For tensors on the
CPU, or on ``meta`` (shapes only: the dry run), the wrapper runs the
plain version (``ref.attention``); for a CUDA tensor it launches the
kernel or raises. ``flash_attention.launches``
counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils.device import PLAIN_DEVICES

#: the reference's tile sizes, which its model routes on (``s % 128 == 0``)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
#: head dims the kernel is built for
HEAD_DIMS = (64, 96, 128, 256)
#: the head dims that take ``flash_wide_kernel`` (the rest ``flash_fwd_kernel``)
WIDE_HEAD_DIMS = (96, 256)
DTYPES = (torch.float32, torch.bfloat16)
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448


class FlashLayout(NamedTuple):
    """How a head dim's kernel lays out one CTA."""
    kernel: str       #: ``flash_fwd_kernel`` or ``flash_wide_kernel``
    warps: int        #: warps a CTA
    split: int        #: warps sharing one block of 16 query rows (each hd / split columns)
    rows: int         #: query rows a CTA
    keys: int         #: keys a K/V tile
    stages: int       #: K/V tiles in the cp.async ring
    ctas_per_sm: int  #: CTAs an SM the launch bounds ask for (the card's registers decide)
    smem_bytes: int   #: dynamic shared memory a CTA


def layout(hd: int, dtype: torch.dtype) -> FlashLayout:
    """The kernel's layout for head dim ``hd`` and input ``dtype`` (the same
    arithmetic as ``csrc/flash_attention.cu``'s ``Layout``, ``WideLayout``
    and ``config``, which refuse any other). ``flash_fwd_kernel``: 3 stages
    of 64-key (hd 64) or 32-key tiles and 2 plane sets, each stage and set
    ``keys * ((hd + 8) + (hd + 4))`` words (a bf16 stage: raw rows of hd).
    ``flash_wide_kernel``: 3 stages of hi planes (``keys * ((hd + 8) + (hd
    + 4))`` words) or raw bf16 rows (``2 * keys`` rows of hd + 8), 2 fp32 lo
    plane sets (``keys * (hd / 2 + 4) + keys / 2 * (hd + 8)`` words) and, at
    hd 256, one exchange slot of 16 rows x keys words a warp.

    These are shared bytes and threads. How many CTAs an SM really holds
    also depends on the registers a thread, which only the build knows:
    :func:`occupancy` asks the card."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} is not one the kernel takes {DTYPES}")
    f32 = dtype == torch.float32
    if hd not in WIDE_HEAD_DIMS:
        keys = 64 if hd == 64 else 32
        planes = 4 * keys * ((hd + 8) + (hd + 4))
        stage = planes if f32 else 2 * keys * 2 * hd
        return FlashLayout("flash_fwd_kernel", 8, 1, 128, keys, 3, 1, 3 * stage + 2 * planes)
    warps, stages = 8, 3
    split = 2 if hd == 256 else 1
    keys = 16 if f32 and hd == 256 else 32
    if f32:
        stage = 4 * keys * ((hd + 8) + (hd + 4))
        lo = 2 * 4 * (keys * (hd // 2 + 4) + keys // 2 * (hd + 8))
    else:
        stage, lo = 2 * 2 * keys * (hd + 8), 0
    exchange = 4 * warps * 16 * keys if split == 2 else 0
    return FlashLayout("flash_wide_kernel", warps, split, 16 * warps // split, keys, stages, 1,
                       stages * stage + lo + exchange)


#: every (head dim, dtype)'s layout, computed once
LAYOUTS = {(hd, dt): layout(hd, dt) for hd in HEAD_DIMS for dt in DTYPES}
#: query rows a CTA, by head dim (the same for both dtypes)
QUERY_TILE = {hd: LAYOUTS[hd, torch.float32].rows for hd in HEAD_DIMS}


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
    rows = QUERY_TILE[hd]
    if B >= 2**16 or -(-sq // rows) >= 2**16:
        raise ValueError(f"batch {B} and query tiles ceil({sq} / {rows}) must each "
                         "be < 65536 (the grid's y, z)")
    if hd in WIDE_HEAD_DIMS and sk >= 2**30:
        raise ValueError(f"key length {sk} must be < 2**30 at head dims {WIDE_HEAD_DIMS} "
                         "(flash_wide_kernel keeps positions in 32 bits)")
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
    lay = LAYOUTS[hd, q.dtype]
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, H, KV, sq, sk, hd,
                  int(q.dtype == torch.bfloat16), int(bool(causal)),
                  int(window is not None), 0 if window is None else int(window),
                  1.0 / math.sqrt(hd), lay.rows, lay.warps, lay.smem_bytes)
    with _build.count_lock:
        flash_attention.launches += 1
    return out


def occupancy(hd: int, dtype: torch.dtype) -> dict[str, int]:
    """What the card makes of the head dim's kernel (built on first use):
    CTAs an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its
    threads and shared bytes), warps an SM, registers and local (spill)
    bytes a thread (``cudaFuncGetAttributes``)."""
    layout(hd, dtype)
    out = (ctypes.c_int * 4)()
    err = _build.library().flash_attention_occupancy(hd, int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"flash_attention_occupancy failed: cudaError {err}")
    ctas, regs, local, threads = out
    return {"ctas_per_sm": ctas, "warps_per_sm": ctas * threads // 32,
            "registers": regs, "local_bytes": local}


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
    if all(t.device.type in PLAIN_DEVICES for t in (q, k, v)):
        return ref.attention(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, causal, window)


flash_attention.launches = 0
