"""The ``lora[:rank]`` pipeline stage: dense tensors -> low-rank factors.

Mirror of ``src/repro/peft/stage.py``. Encode decomposes each eligible
float matrix into a truncated-SVD factor pair
(:func:`repro_torch.kernels.ops.low_rank_decompose`, on the pipeline's
device) and ships a :class:`~repro_torch.peft.lowrank.LowRankDelta`;
decode merges the factors back to a dense tensor. Spec forms::

    "lora"                     # rank 8
    "lora:16"                  # rank 16
    {"stage": "lora", "rank": 8, "alpha": 16, "min_params": 4096}

Eligibility: plain float tensors with at least 2 dims (leading dims
collapse into the rows), ``min_params`` or more elements, a rank that
fits, and factors smaller than the dense form (``rank * (m + n) <
m * n``); everything else passes through untouched, so a stacked
``lora:8 -> quantize:nf4`` pipeline low-ranks the big matrices and
quantizes what the lora stage skipped.

Decomposition is deterministic (the exact SVD plus sign
canonicalization), so the stage is stateless and re-encoding the same
payload yields identical wire bytes — the contract the async scheduler's
double encode relies on.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import Stage, WireContext, register_stage
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.peft.lowrank import LowRankDelta
from repro_torch.utils.trees import as_tensor, numpy_dtype


def _matrix_dims(shape: tuple[int, ...]) -> tuple[int, int]:
    """Collapse leading dims: the decomposed matrix is (prod(lead), last)."""
    return math.prod(shape[:-1]), int(shape[-1])


@register_stage("lora")
class LoRAStage(Stage):
    """Per-item low-rank decomposition (parameter-efficient payloads)."""

    def __init__(self, rank: int = 8, alpha: Optional[float] = None,
                 min_params: int = 1024) -> None:
        if rank < 1:
            raise ValueError(f"lora stage needs rank >= 1, got {rank}")
        self.rank = int(rank)
        # alpha defaults to rank: merge scale 1, so a decomposed tensor
        # round-trips to its best rank-r approximation
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.min_params = int(min_params)

    @classmethod
    def from_spec(cls, arg: Optional[str] = None, **kwargs: Any) -> LoRAStage:
        if arg is not None:
            kwargs.setdefault("rank", int(arg))
        return cls(**kwargs)

    def _eligible(self, value: Any) -> bool:
        if isinstance(value, LowRankDelta):  # already factored (native adapters)
            return False
        if not hasattr(value, "dtype"):
            value = np.asarray(value)
        if isinstance(value, torch.Tensor):
            is_float = value.is_floating_point()
        else:
            try:
                is_float = numpy_dtype(value.dtype).kind == "f"
            except TypeError:
                return False
        shape = tuple(value.shape)
        if not is_float or len(shape) < 2:
            return False
        m, n = _matrix_dims(shape)
        if m * n < self.min_params or self.rank > min(m, n):
            return False
        return self.rank * (m + n) < m * n

    def begin_encode(self, message, ctx: WireContext):
        ctx.headers["lora_rank"] = self.rank
        return message

    def end_decode(self, message, ctx: WireContext):
        if ctx.decode_values:
            message.headers.pop("lora_rank", None)
        return message

    def encode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        if not self._eligible(value):
            return value
        x = as_tensor(value, ctx.device)
        m, n = _matrix_dims(tuple(x.shape))
        with obs_trace.span("kernel.lora_decompose", "kernel", item=name,
                            m=m, n=n, rank=self.rank):
            a, b = ops.low_rank_decompose(x.reshape(m, n), self.rank)
        ctx.vmeta["r"] = self.rank
        ctx.vmeta["n"] = x.numel()
        return LowRankDelta(a, b, self.alpha, self.rank, tuple(x.shape),
                            numpy_dtype(x.dtype))

    def decode_item(self, name: str, value: Any, ctx: WireContext) -> Any:
        return value.to_dense(ctx.device) if isinstance(value, LowRankDelta) else value
