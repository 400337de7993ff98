"""Low-rank factor-pair wire type (LoRA adapters / truncated deltas).

Mirror of ``src/repro/peft/lowrank.py``. :class:`LowRankDelta` is the
wire form of a parameter-efficient payload item: instead of a dense
``(m, n)`` tensor the message carries the factor pair ``a (m, r)`` /
``b (r, n)`` plus the LoRA scaling metadata, so the item costs
``r * (m + n)`` floats on the wire instead of ``m * n``. It crosses the
wire through :mod:`repro_torch.core.serialization` as its own
``"lowrank"`` item kind; the ``lora`` stage (:mod:`repro_torch.peft.stage`)
produces and consumes it per item inside the streaming loop.

The factors are torch tensors while they stay on the device (the stage's
decomposition, native adapters) and numpy arrays once decoded from the
wire, as a :class:`~repro_torch.core.quantization.QuantizedTensor`'s
payload is. ``orig_dtype`` is a numpy dtype, as the wire header names it.

The dense form is ``(alpha / rank) * (a @ b)``, the LoRA scaling
convention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.trees import as_tensor, torch_dtype


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


@dataclasses.dataclass
class LowRankDelta:
    """Wire format for one low-rank factored tensor."""

    a: Any                               # (m, rank) left factor
    b: Any                               # (rank, n) right factor
    alpha: float                         # LoRA scale numerator
    rank: int
    orig_shape: tuple[int, ...]          # dense shape ((m, n) or higher-rank)
    orig_dtype: Any

    @property
    def total_bytes(self) -> int:
        return _nbytes(self.a) + _nbytes(self.b)

    @property
    def scale(self) -> float:
        """The LoRA merge scale ``alpha / rank``."""
        return float(self.alpha) / float(self.rank)

    @property
    def dense_bytes(self) -> int:
        """What the dense form would cost at original dtype."""
        return math.prod(self.orig_shape) * np.dtype(self.orig_dtype).itemsize

    def to_dense(self, device: Optional[Any] = None) -> torch.Tensor:
        """Merge the factors on ``device`` (default: where ``a`` is):
        ``(alpha / rank) * (a @ b)`` reshaped and cast back to the
        original dtype (:func:`repro_torch.kernels.ops.low_rank_merge`)."""
        from repro_torch.kernels import ops  # lazy: keep the wire type import-light

        if device is None:
            device = self.a.device if isinstance(self.a, torch.Tensor) else "cpu"
        dense = ops.low_rank_merge(as_tensor(self.a, device), as_tensor(self.b, device),
                                   self.scale)
        return dense.reshape(self.orig_shape).to(torch_dtype(self.orig_dtype))
