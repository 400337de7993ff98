"""Quantized / bucketed cross-pod collectives on ``torch.distributed``.

Mirror of ``src/repro/core/collectives.py``, name for name. The pod axis
of the reference's mesh is a process group here, one rank per pod
(default: the world group); the paper's two techniques map onto it as
there:

* **message quantization -> low-precision collectives**: the flat update
  is blockwise-int8 quantized before it crosses the group (B1); every
  rank all-gathers the codes and absmax of every rank and forms the
  mean at fp32 with the fused K-way dequantize-and-sum (B6). Each rank
  sums the same gathered stack in the same order, so every rank ends
  with the same bits.
* **streaming -> bucketed collectives**: the flat update goes through in
  fixed-size buckets of whole 4096-blocks, reusing one gather buffer, so
  the live int8 buffer is bounded by the bucket, not the model. A block
  sees the same elements and the same arithmetic either way, so the
  bucketed mean equals the unbucketed one bitwise.

Trees are nested dicts (and lists) of tensors, flattened in the
reference's leaf order — ``jax.tree_util`` order, keys sorted at each
level, which is :func:`repro_torch.utils.trees.flatten_state_dict`'s.
Another order would move the block boundaries, and with them every
code. Leaves are concatenated into one flat fp32 vector, so blocks
straddle leaves, as in the reference.

With tracing on, the spans ``coll.quantize``, ``coll.all_gather`` and
``kernel.dequant_accumulate8`` time the three steps of each (bucket's)
collective.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Mapping
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels.ref import BLOCK8
from repro_torch.obs import trace as obs_trace

BLOCK = BLOCK8
#: the reference's default bucket size (``bucketed_quantized_pod_mean``)
DEFAULT_BUCKET_BYTES = 64 << 20


def _map_leaves(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` with ``fn`` applied to each leaf, visiting leaves in
    :func:`flatten_state_dict` order (keys sorted at each level)."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _flatten_tree(tree: Any) -> tuple[torch.Tensor, Any, list[int]]:
    leaves: list[torch.Tensor] = []
    skeleton = _map_leaves(tree, leaves.append)
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    return flat, (skeleton, [leaf.shape for leaf in leaves],
                  [leaf.dtype for leaf in leaves]), sizes


def _unflatten_tree(flat: torch.Tensor, meta: Any, sizes: list[int]) -> Any:
    skeleton, shapes, dtypes = meta
    leaves = []
    off = 0
    for shape, dtype, size in zip(shapes, dtypes, sizes):
        leaves.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    it = iter(leaves)
    return _map_leaves(skeleton, lambda _: next(it))


def _quantize_flat(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad to whole blocks and quantize: ((nblocks, 4096) int8,
    (nblocks,) fp32 absmax)."""
    return ops.quantize_blockwise8(flat)


def _all_gather(t: torch.Tensor, out: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Every rank's ``t`` into ``out`` (P, *t.shape), in rank order, through
    the list form of ``all_gather`` over views of ``out``."""
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out


def _gather_buffers(nblocks: int, group: Optional[Any],
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    P = dist.get_world_size(group)
    return (torch.empty((P, nblocks, BLOCK), dtype=torch.int8, device=device),
            torch.empty((P, nblocks), dtype=torch.float32, device=device))


def _pod_mean_blocks(flat: torch.Tensor, group: Optional[Any],
                     q_all: torch.Tensor, am_all: torch.Tensor) -> torch.Tensor:
    """The pod mean of one flat vector (padded to whole blocks) through
    the gather buffers ``q_all`` / ``am_all`` -> (nblocks, 4096) fp32."""
    with obs_trace.span("coll.quantize", "coll", elements=flat.numel()):
        q, absmax = _quantize_flat(flat)
    with obs_trace.span("coll.all_gather", "coll",
                        wire_bytes=q_all.numel() + 4 * am_all.numel()):
        _all_gather(q, q_all, group)
        _all_gather(absmax, am_all, group)
    del q, absmax
    P = q_all.shape[0]
    w = torch.full((P,), 1.0 / P, dtype=torch.float32, device=flat.device)
    with obs_trace.span("kernel.dequant_accumulate8", "coll", pods=P):
        return ops.dequant_accumulate8(q_all, am_all, w)


def quantized_pod_mean(flat: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """Mean of a flat fp32 vector across the group with int8 wire format.

    Egress: blockwise-int8 quantize. Wire: all_gather of (codes, absmax).
    Ingress: dequantize each pod's payload and average at fp32 (the
    paper's aggregation at original precision), fused in one kernel.
    """
    n = flat.numel()
    q_all, am_all = _gather_buffers(math.ceil(n / BLOCK), group, flat.device)
    out = _pod_mean_blocks(flat, group, q_all, am_all)
    return out.reshape(-1)[:n]


def bucketed_quantized_pod_mean(
    flat: torch.Tensor, *, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    group: Optional[Any] = None,
) -> torch.Tensor:
    """Streaming variant: quantize + gather + reduce one bucket of
    ``bucket_bytes`` of fp32 (whole blocks, at least one) at a time, so
    the live int8 gather buffer is bounded by ``bucket_bytes / 4 * P``.
    The last bucket is zero-padded to full size, as the reference pads
    the whole vector; the gather buffers are allocated once."""
    n = flat.numel()
    bucket_elems = max(BLOCK, (bucket_bytes // 4) // BLOCK * BLOCK)
    nb = math.ceil(n / bucket_elems)
    out = torch.empty(nb * bucket_elems, dtype=torch.float32, device=flat.device)
    q_all, am_all = _gather_buffers(bucket_elems // BLOCK, group, flat.device)
    for i in range(nb):
        bucket = flat[i * bucket_elems:(i + 1) * bucket_elems]
        if bucket.numel() < bucket_elems:
            bucket = torch.nn.functional.pad(bucket, (0, bucket_elems - bucket.numel()))
        mean = _pod_mean_blocks(bucket, group, q_all, am_all)
        out[i * bucket_elems:(i + 1) * bucket_elems] = mean.reshape(-1)
        del mean
    return out[:n]


def quantized_fedavg_tree(tree: Any, group: Optional[Any] = None,
                          bucket_bytes: Optional[int] = None) -> Any:
    """FedAvg a tree of updates across the group (int8 wire); bucketed
    when ``bucket_bytes`` is given."""
    flat, meta, sizes = _flatten_tree(tree)
    if bucket_bytes:
        out = bucketed_quantized_pod_mean(flat, bucket_bytes=bucket_bytes, group=group)
    else:
        out = quantized_pod_mean(flat, group)
    del flat
    return _unflatten_tree(out, meta, sizes)


def fp32_fedavg_tree(tree: Any, group: Optional[Any] = None) -> Any:
    """The paper-faithful fp32 baseline: each leaf summed across the group
    (``all_reduce``), then divided by its size — the reference's ``pmean``
    (gloo has no averaging reduce)."""
    P = dist.get_world_size(group)

    def mean(x: torch.Tensor) -> torch.Tensor:
        s = x.to(torch.float32).clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s.div_(P).to(x.dtype)

    return _map_leaves(tree, mean)
