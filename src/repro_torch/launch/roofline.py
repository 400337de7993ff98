"""Roofline terms of a counted step on an NVIDIA card.

Mirror of ``src/repro/launch/roofline.py``. Per (arch x shape x mesh):

    compute term    = counted FLOPs per device / the card's peak for the step's type
    memory term     = counted bytes per device / HBM rate
    collective term = collective wire bytes per device / NVLink rate (one direction)

The counts come from ``repro_torch.launch.dryrun`` (a meta-device run of
the port's step: FLOPs by ``torch.utils.flop_counter``'s formulas, bytes
as each aten op's inputs and outputs, collectives by DTensor's); they
are per-device quantities. The peaks come from :data:`PEAKS`, keyed by
the card's name as ``torch.cuda.get_device_name()`` gives it; a card not
in the table raises. MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference)
with N = active params — the ratio MODEL_FLOPS / counted FLOPs exposes
remat, dispatch and redundancy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.base import ModelConfig, active_param_count


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """Published peaks of one card (dense rates, no sparsity)."""
    hbm_bytes_per_s: float
    fp32_flops: float            # fp32 outside the tensor cores
    tf32_flops: float            # tensor cores, tf32
    bf16_flops: float            # tensor cores, bf16 / fp16
    link_bytes_per_s: float      # NVLink, one direction


#: NVIDIA H100 SXM (data sheet; its figures assume the 700 W power limit)
H100_SXM = CardPeaks(hbm_bytes_per_s=3.35e12, fp32_flops=67e12, tf32_flops=495e12,
                     bf16_flops=989e12, link_bytes_per_s=450e9)
PEAKS: dict[str, CardPeaks] = {"NVIDIA H100 80GB HBM3": H100_SXM}

HBM_BYTES_PER_S = H100_SXM.hbm_bytes_per_s
FP32_OPS_PER_S = H100_SXM.fp32_flops
TF32_OPS_PER_S = H100_SXM.tf32_flops
BF16_OPS_PER_S = H100_SXM.bf16_flops


def peaks_for(card: str) -> CardPeaks:
    """The peaks of the card named ``card``; raises for a card not in
    :data:`PEAKS` (there is no default)."""
    if card not in PEAKS:
        raise KeyError(f"no peaks for card {card!r}; known: {sorted(PEAKS)}")
    return PEAKS[card]


def compute_peak(peaks: CardPeaks, dtype: torch.dtype, tf32: bool) -> float:
    """The FLOP/s a step in ``dtype`` can reach: bf16/fp16 on the tensor
    cores; fp32 on the tensor cores only with TF32 on, else on the CUDA
    cores (the port trains and serves with TF32 off)."""
    if dtype in (torch.bfloat16, torch.float16):
        return peaks.bf16_flops
    if dtype == torch.float32:
        return peaks.tf32_flops if tf32 else peaks.fp32_flops
    raise ValueError(f"no compute peak for dtype {dtype}")


def collective_wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Ring model of one collective's bytes on the wire per device, as the
    reference's HLO counter has it (``src/repro/utils/hlo.py``):
    all-reduce 2 s (n-1)/n; all-gather, reduce-scatter and all-to-all
    s (n-1)/n; a permute s; s the result's bytes."""
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "collective-permute":
        return float(result_bytes)
    return result_bytes * frac


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    variant: str
    chips: int
    card: str
    compute_peak_flops: float
    counted_flops: float
    counted_bytes: float
    collective_wire_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_flop_ratio: float
    collective_detail: dict[str, dict[str, float]]
    memory_per_device: Optional[dict[str, float]] = None

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int) -> float:
    n = active_param_count(cfg)
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * global_batch


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    variant: str,
    chips: int,
    cfg: ModelConfig,
    kind: str,
    seq_len: int,
    global_batch: int,
    flops: float,
    bytes_accessed: float,
    collectives: dict[str, dict[str, float]],
    card: str,
    dtype: torch.dtype,
    tf32: bool,
    memory_per_device: Optional[dict[str, float]] = None,
) -> RooflineReport:
    """The roofline of one counted step. ``flops``, ``bytes_accessed`` and
    ``collectives`` ({kind: {count, result_bytes, wire_bytes}}) are
    per-device counts."""
    peaks = peaks_for(card)
    peak = compute_peak(peaks, dtype, tf32)
    wire = sum(s["wire_bytes"] for s in collectives.values())
    mf = model_flops(cfg, kind, seq_len, global_batch)
    compute_s = flops / peak
    memory_s = bytes_accessed / peaks.hbm_bytes_per_s
    collective_s = wire / peaks.link_bytes_per_s
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        variant=variant,
        chips=chips,
        card=card,
        compute_peak_flops=peak,
        counted_flops=flops,
        counted_bytes=bytes_accessed,
        collective_wire_bytes=wire,
        model_flops=mf,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        useful_flop_ratio=(mf / (flops * chips)) if flops else 0.0,
        collective_detail=collectives,
        memory_per_device=memory_per_device,
    )
