"""Top-k sparsification wire type (paper §V "sparsification ... based on
network conditions", Shahid et al.'s gradient-sparsification family).

:class:`SparseTensor` is the wire form of a magnitude-pruned tensor:
flat indices of the surviving entries plus their values, with the
original shape/dtype to rebuild a dense array on decode. It crosses the
wire through :mod:`repro_torch.core.serialization` exactly like
:class:`~repro_torch.core.quantization.QuantizedTensor`, and the ``topk``
pipeline stage produces/consumes it per item inside the streaming loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


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

    def to_dense(self) -> np.ndarray:
        out = np.zeros(int(np.prod(self.orig_shape)) if self.orig_shape else 1,
                       dtype=np.dtype(self.orig_dtype))
        out[self.indices] = self.values
        return out.reshape(self.orig_shape)


def topk_sparsify(arr: np.ndarray, fraction: float) -> SparseTensor:
    """Keep the ``ceil(fraction * n)`` largest-magnitude entries.

    Selection is deterministic: ties resolve toward the lower flat index
    (stable argsort), so the same tensor always sparsifies to the same
    wire bytes.
    """
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"topk fraction must be in (0, 1], got {fraction}")
    flat = np.asarray(arr).reshape(-1)
    k = max(1, int(np.ceil(fraction * flat.size)))
    order = np.argsort(-np.abs(flat), kind="stable")[:k]
    idx = np.sort(order).astype(np.int64 if flat.size > np.iinfo(np.int32).max
                                else np.int32)
    # fancy indexing already materializes a fresh values array — a
    # defensive .copy() here would be a second, redundant copy per item
    return SparseTensor(idx, flat[idx], tuple(np.asarray(arr).shape),
                        np.asarray(arr).dtype)
