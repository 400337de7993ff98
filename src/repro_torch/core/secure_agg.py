"""Secure aggregation (paper §V: compatibility with other
privacy-preserving mechanisms).

Mirror of ``src/repro/core/secure_agg.py``: pairwise additive masking on
an integer grid (Bonawitz et al. style, the key exchange out of band).
Each client pair (i, j) derives one mask stream from a common seed;
client i adds it and client j subtracts it, all arithmetic in int64 mod
2**32 over a fixed-point grid. Individual Task Results look like noise to
the server; their *sum* telescopes exactly, so FedAvg over the unmasked
grid values is recovered bit for bit.

Grids are ``int64`` tensors on the filter's (or aggregator's) device and
cross the wire as ``uint32`` (4 bytes a parameter). Masks are drawn on
the host with the reference's own numpy generator, seeded by
:func:`_pair_seed`, and moved to the device, so both packages mask with
the same numbers.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
import torch

from repro_torch.core.filters import Filter, _is_float
from repro_torch.core.messages import Message
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_tensor

MOD = 1 << 32
SCALE = float(1 << 16)  # fixed point: ~1.5e-5 resolution, +-32k range


def _pair_seed(base_seed: int, i: int, j: int, name: str, rnd: int) -> np.random.Generator:
    """The mask stream of client pair (i, j) for item ``name`` in round
    ``rnd``. It is keyed by ``hash()`` of a tuple holding a ``str``, as the
    reference's is, so masks agree only within one process (ROADMAP C8)."""
    lo, hi = (i, j) if i < j else (j, i)
    return np.random.default_rng(
        abs(hash((base_seed, lo, hi, name, rnd))) % (2**63)
    )


def _to_grid(x: torch.Tensor) -> torch.Tensor:
    """Fixed-point grid of ``x`` mod 2**32, as int64 on ``x``'s device
    (float64 product, rounded half to even as ``np.round`` does)."""
    return torch.round(x.to(torch.float64) * SCALE).to(torch.int64) % MOD


def _from_grid(g: torch.Tensor) -> torch.Tensor:
    """Recentred grid values as float32. The divisor is a device tensor:
    a CUDA tensor divided by a host scalar is multiplied by its
    reciprocal instead."""
    g = g.to(torch.int64) % MOD
    g = torch.where(g >= MOD // 2, g - MOD, g)
    scale = torch.tensor(SCALE, dtype=torch.float64, device=g.device)
    return (g.to(torch.float64) / scale).to(torch.float32)


def masked_grid(value: Any, client_index: int, all_clients: Sequence[int],
                base_seed: int, name: str, rnd: int, device: torch.device) -> torch.Tensor:
    """``value`` on the grid plus client ``client_index``'s pairwise masks
    (added towards higher indices, subtracted towards lower ones), as the
    ``uint32`` wire tensor on ``device``."""
    g = _to_grid(as_tensor(value, device))
    for other in all_clients:
        if other == client_index:
            continue
        mask = _pair_seed(base_seed, client_index, other, name, rnd).integers(
            0, MOD, size=tuple(g.shape), dtype=np.int64
        )
        mask_t = torch.from_numpy(mask).to(device)
        g = (g + mask_t) % MOD if client_index < other else (g - mask_t) % MOD
    return g.to(torch.uint32)


def _is_uint32(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return value.dtype == torch.uint32
    return isinstance(value, np.ndarray) and value.dtype == np.uint32


class SecureMaskFilter(Filter):
    """Client side: fixed-point encode plus pairwise masks (mod 2**32) on
    ``device`` (CUDA by default)."""

    def __init__(self, client_index: int, all_clients: Sequence[int], base_seed: int = 0,
                 device: Any = None) -> None:
        self.client_index = client_index
        self.all_clients = list(all_clients)
        self.base_seed = base_seed
        self.device = resolve_device(device)

    def process(self, message: Message) -> Message:
        rnd = int(message.headers.get("round", 0))
        out: dict[str, Any] = {}
        for name, value in message.payload.items():
            if not _is_float(value):
                out[name] = value
                continue
            out[name] = masked_grid(value, self.client_index, self.all_clients,
                                    self.base_seed, name, rnd, self.device)
        msg = message.replace_payload(out)
        msg.headers["secure_masked"] = True
        return msg


class SecureAggregator:
    """Server side: sums masked grids (the masks telescope to zero) and
    decodes the mean onto ``device``. Requires every configured client to
    report — the standard SecAgg liveness assumption."""

    def __init__(self, num_clients: int, device: Any = None) -> None:
        self.num_clients = num_clients
        self.device = resolve_device(device)
        self._sum: dict[str, torch.Tensor] = {}
        self._weights: list[float] = []
        self._extra: dict[str, Any] = {}

    def accept(self, result: Message) -> None:
        if not result.headers.get("secure_masked"):
            raise ValueError("SecureAggregator needs masked results")
        for name, value in result.payload.items():
            if _is_uint32(value):
                g = as_tensor(value, self.device).to(torch.int64)
                if name in self._sum:
                    self._sum[name] = (self._sum[name] + g) % MOD
                else:
                    self._sum[name] = g % MOD
            else:
                self._extra[name] = value
        self._weights.append(float(result.headers.get("num_samples", 1)))

    def finish(self) -> dict[str, Any]:
        if len(self._weights) != self.num_clients:
            raise RuntimeError(
                f"SecAgg needs all {self.num_clients} clients, got {len(self._weights)}"
            )
        n = torch.tensor(self.num_clients, dtype=torch.float32, device=self.device)
        out: dict[str, Any] = {
            name: _from_grid(total) / n for name, total in self._sum.items()
        }
        out.update(self._extra)
        self._sum = {}
        self._weights = []
        self._extra = {}
        return out
