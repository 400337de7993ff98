"""The yardstick's arithmetic: model FLOPs of a round's local training,
the least HBM bytes of a round's codec work, and the card's peaks.

FLOPs are the configuration's reference's count of one local step
(``train_flops_per_step``: forward and backward, no recompute) at the
traffic's batch and sequence, for every step of every client.

Codec bytes follow the message's shapes, the reference's leaves, each
tensor read or written once: an encode reads the float32 tensor and
writes codes and one fp32 scale a block; a decode reads codes and scales
and writes float32; the streaming int8 fold reads codes and scales and
reads and writes the float32 accumulator.
"""
from __future__ import annotations

import math
from typing import Any

from fedbench import reference
from fedbench.reference import codec

#: published dense peaks of a card (NVIDIA data sheet, SXM, 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "tf32_flops": 495e12,
                              "fp32_flops": 67e12, "bf16_flops": 989e12},
}


def train_flops_per_step(cfg: dict[str, Any], batch: int, seq: int) -> float:
    return reference.load(cfg).train_flops_per_step(cfg, batch, seq)


def flops_per_round(cfg: dict[str, Any], traffic: dict[str, Any]) -> float:
    t = traffic["spec"]
    return t["clients"] * t["local_steps"] * train_flops_per_step(cfg, t["batch"], t["seq"])


def _wire_bytes(n: int, fmt: str) -> tuple[int, int]:
    """(codes, scales) bytes of one tensor of ``n`` elements."""
    nb = math.ceil(n / codec.BLOCK[fmt])
    codes = n if fmt == "blockwise8" else math.ceil(n / 2)
    return codes, 4 * nb


def codec_bytes_per_round(cfg: dict[str, Any], traffic: dict[str, Any],
                          fmt_down: str, fmt_up: str) -> float:
    t = traffic["spec"]
    fold8 = t["aggregator"] == "quantized-fedavg"
    total = 0
    for shape, _ in reference.load(cfg).param_specs(cfg).values():
        n = math.prod(shape)
        dc, ds = _wire_bytes(n, fmt_down)
        uc, us = _wire_bytes(n, fmt_up)
        encode_down = 4 * n + dc + ds
        decode_down = dc + ds + 4 * n
        encode_up = 4 * n + uc + us
        server = uc + us + (8 * n if fold8 else 4 * n)   # fold, or a decode
        total += encode_down + decode_down + encode_up + server
    return float(t["clients"] * total)
