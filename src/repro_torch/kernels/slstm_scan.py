"""sLSTM time scan: the wrapper over the CUDA kernel.

Replaces ``src/repro/kernels/slstm_scan.py`` (``slstm_scan_pallas``).
Kernel: ``csrc/slstm_scan.cu`` (``slstm_cluster_kernel``): a cluster of
4 CTAs per (batch row, head), one per gate, each holding its gate's
slice of r in shared memory for the whole sequence; each step the four
exchange their pre-activations through distributed shared memory and
meet at one cluster barrier. Where one gate's slice does not fit a
block's shared memory (hd above 224), each gate splits over 2 CTAs: a
cluster of 8. :func:`cluster_layout` picks the layout from hd; the
kernel needs ``sm_90a`` (clusters).

Bound on an H100: neither bytes nor operations but the S dependent
steps. The bytes (gx read once, h written once, r read once) and the
``2 * 4 * hd`` operations per state element a step are a small fraction
of one millisecond at serving's shapes; the kernel's time per step is
the number to watch (``PERF.md``).

The reference's kernel returns h only; this one also returns the final
state (c, n, h, m), which prefill keeps as the decode cache (the
reference takes it from its ``lax.scan``). Like the reference's, the
kernel is forward-only: the op is a ``torch.autograd.Function`` whose
backward raises. For tensors on the CPU, or on ``meta`` (shapes only:
the dry run), the wrapper runs the plain version (``ref.slstm_scan``);
for CUDA tensors it launches the kernel or raises. ``slstm_scan.launches`` counts its kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils.device import PLAIN_DEVICES

#: the reference's sequence chunk (its grid step). The kernel walks the whole
#: sequence in one launch; ``S % chunk == 0`` is checked as the reference asserts it
DEFAULT_CHUNK = 256
#: the largest head dim the kernel takes (a cluster of 8 at hd 256)
MAX_HEAD_DIM = 256
GX_DTYPES = (torch.float32, torch.bfloat16)
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: k-slices per column pair: a warp is 8 column pairs x 4 slices
SLICES = 4


class ClusterLayout(NamedTuple):
    """How the kernel lays out one (batch row, head)."""
    cluster: int      #: CTAs in the cluster: 4, or 8 when each gate spans 2
    split: int        #: CTAs per gate
    threads: int      #: threads a CTA
    smem_bytes: int   #: dynamic shared memory a CTA


def cluster_layout(hd: int) -> ClusterLayout:
    """The kernel's layout for head dim ``hd`` (the same arithmetic as
    ``csrc/slstm_scan.cu::layout_for``, which refuses any other): each CTA
    holds its columns of one gate's r, hd rounded up to 16 rows by two
    columns per thread (pairs padded to whole warps), the exchange slots
    (2 parities x 4 gates x hd) and h. One CTA per gate where that fits
    :data:`SMEM_LIMIT`, else two."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    for split in (1, 2):
        ncols = -(-hd // split)
        pairs = (-(-ncols // 2) + 7) // 8 * 8
        hd_k = -(-hd // 16) * 16
        smem = 4 * (hd_k * 2 * pairs + 2 * 4 * hd + hd_k)
        if smem <= SMEM_LIMIT:
            return ClusterLayout(4 * split, split, pairs * SLICES, smem)
    raise AssertionError(f"no layout fits head dim {hd}")   # unreachable for hd <= 256


def check_inputs(gx: torch.Tensor, r: torch.Tensor, num_heads: int, chunk: int) -> None:
    """Raise ``ValueError`` unless gx is (B, S, 4, D) fp32 or bf16 and r is
    (4, H, hd, hd) fp32 with H = ``num_heads``, D = H * hd, and S a
    multiple of ``chunk`` (the reference asserts the same)."""
    if gx.ndim != 4 or gx.shape[2] != 4:
        raise ValueError(f"gx must be (B, S, 4, D), got {tuple(gx.shape)}")
    if gx.dtype not in GX_DTYPES:
        raise ValueError(f"gx must be float32 or bfloat16, got {gx.dtype}")
    if r.dtype != torch.float32:
        raise ValueError(f"r must be float32, got {r.dtype}")
    B, S, _, D = gx.shape
    H = num_heads
    if H <= 0 or D % H:
        raise ValueError(f"D = {D} does not split into {H} heads")
    hd = D // H
    if tuple(r.shape) != (4, H, hd, hd):
        raise ValueError(f"r must be (4, {H}, {hd}, {hd}), got {tuple(r.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")


def _launch(gx: torch.Tensor, r: torch.Tensor,
            num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, _, D = gx.shape
    H = num_heads
    hd = D // H
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}: the kernel's largest layout is a "
                         "cluster of 8 at hd 256")
    if B >= 2**16 or S >= 2**31 or H >= 2**31:
        raise ValueError(f"batch {B} must be < 65536 (the grid's y), S {S} and heads {H} "
                         "< 2**31")
    for name, t in (("gx", gx), ("r", r)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.device != gx.device:
        raise ValueError(f"r is on {r.device}, gx on {gx.device}")
    h = torch.empty((B, S, D), dtype=torch.float32, device=gx.device)
    state = torch.empty((4, B, H, hd), dtype=torch.float32, device=gx.device)
    if B:
        layout = cluster_layout(hd)
        _build.launch("slstm_scan_fwd", gx.device, gx.data_ptr(), r.data_ptr(), h.data_ptr(),
                      state.data_ptr(), B, S, H, hd, int(gx.dtype == torch.bfloat16),
                      layout.split, layout.threads, layout.smem_bytes)
        with _build.count_lock:
            slstm_scan.launches += 1
    return h, state


class _SLSTMScan(torch.autograd.Function):
    """The kernel as an autograd op with no gradient."""

    @staticmethod
    def forward(ctx, gx, r, num_heads):
        return _launch(gx, r, num_heads)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the sLSTM scan kernel is forward-only: the reference's kernel "
            "(slstm_scan_pallas) has no gradient either; train through the "
            "cell loop (models/ssm.py::slstm_block_forward)")


def slstm_scan(gx: torch.Tensor, r: torch.Tensor, *, num_heads: int,
               chunk: int = DEFAULT_CHUNK) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """gx: (B, S, 4, D) gate pre-activations, order z, i, f, o (fp32 or
    bf16); r: (4, H, hd, hd) fp32 -> h (B, S, D) fp32 and the final state
    (c, n, h, m), each (B, H, hd) fp32. ``S % chunk == 0``."""
    check_inputs(gx, r, num_heads, chunk)
    if gx.device.type in PLAIN_DEVICES and r.device.type in PLAIN_DEVICES:
        return ref.slstm_scan(gx, r, num_heads)
    h, state = _SLSTMScan.apply(gx, r, num_heads)
    return h, tuple(state.unbind(0))


slstm_scan.launches = 0
