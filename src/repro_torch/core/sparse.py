"""Top-k sparsification wire type (paper §V "sparsification ... based on
network conditions", Shahid et al.'s gradient-sparsification family).

:class:`SparseTensor` is the wire form of a magnitude-pruned tensor:
flat indices of the surviving entries plus their values, with the
original shape/dtype to rebuild a dense array on decode. It crosses the
wire through :mod:`repro_torch.core.serialization` exactly like
:class:`~repro_torch.core.quantization.QuantizedTensor`, and the ``topk``
pipeline stage produces/consumes it per item inside the streaming loop.

Selection runs where the tensor is: a torch tensor (on the card or the
CPU) is sparsified by a stable ``torch.sort`` on its device, a numpy
array by the reference's stable ``argsort`` on the host. Both keep the
same entries — ties toward the lower flat index, NaN last — so the wire
bytes are the reference's either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.utils.trees import as_numpy, as_tensor, numpy_dtype, torch_dtype


@dataclasses.dataclass
class SparseTensor:
    """Wire format for one top-k-sparsified tensor."""

    indices: np.ndarray                  # int32/int64 flat indices, sorted
    values: np.ndarray                   # surviving entries, original dtype
    orig_shape: tuple[int, ...]
    orig_dtype: Any

    @property
    def total_bytes(self) -> int:
        return int(self.indices.nbytes) + int(self.values.nbytes)

    @property
    def density(self) -> float:
        n = int(np.prod(self.orig_shape)) if self.orig_shape else 1
        return len(self.values) / max(1, n)

    def to_dense(self, device: Any) -> torch.Tensor:
        """The dense form on ``device``, zeros elsewhere."""
        out = torch.zeros(math.prod(self.orig_shape), dtype=torch_dtype(self.orig_dtype),
                          device=device)
        out[as_tensor(self.indices, device).long()] = as_tensor(self.values, device)
        return out.reshape(self.orig_shape)


def _index_dtype(n: int) -> Any:
    return np.int64 if n > np.iinfo(np.int32).max else np.int32


def _topk_tensor(x: torch.Tensor, k: int) -> SparseTensor:
    """Device selection: a stable sort of ``-|x|`` with each NaN's key
    made ``+inf`` (no other key is positive), so NaNs sort last in index
    order whatever their sign and payload, as numpy's sort puts them."""
    flat = x.reshape(-1)
    key = torch.where(torch.isnan(flat), torch.full_like(flat, math.inf), -flat.abs())
    order = torch.sort(key, stable=True).indices[:k]
    idx = torch.sort(order).values
    values = flat[idx]
    return SparseTensor(as_numpy(idx).astype(_index_dtype(flat.numel())), as_numpy(values),
                        tuple(x.shape), numpy_dtype(x.dtype))


def topk_sparsify(arr: Any, fraction: float) -> SparseTensor:
    """Keep the ``ceil(fraction * n)`` largest-magnitude entries.

    Selection is deterministic: ties resolve toward the lower flat index
    (stable sort), so the same tensor always sparsifies to the same wire
    bytes. A torch tensor is sorted on its device, numpy on the host.
    """
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"topk fraction must be in (0, 1], got {fraction}")
    if isinstance(arr, torch.Tensor):
        return _topk_tensor(arr, max(1, math.ceil(fraction * arr.numel())))
    flat = np.asarray(arr).reshape(-1)
    k = max(1, int(np.ceil(fraction * flat.size)))
    order = np.argsort(-np.abs(flat), kind="stable")[:k]
    idx = np.sort(order).astype(_index_dtype(flat.size))
    # fancy indexing already materializes a fresh values array — a
    # defensive .copy() here would be a second, redundant copy per item
    return SparseTensor(idx, flat[idx], tuple(np.asarray(arr).shape),
                        np.asarray(arr).dtype)
