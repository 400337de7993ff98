"""Assigned input shapes and meta-device stand-ins for the dry run.

Mirror of ``src/repro/launch/specs.py``. The four shapes:

=============  ==========  ============  ===================
name           seq_len     global_batch  step
=============  ==========  ============  ===================
train_4k       4,096       256           train step
prefill_32k    32,768      32            prefill
decode_32k     32,768      128           decode step (1 token)
long_500k      524,288     1             decode step (1 token)
=============  ==========  ============  ===================

``long_500k`` needs sub-quadratic attention: native for ssm/hybrid;
dense-family archs run it under the sliding-window *variant*
(``variant='swa'``, window 4096). The stand-ins are tensors on the
``meta`` device, which hold a shape and a dtype and no data, in place of
the reference's ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import create_model
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig

SWA_WINDOW = 4096

INPUT_SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

# families whose serve path is O(1)/O(window) state natively
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapePlan:
    shape_name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int
    variant: str                 # "paper" | "swa"
    skip_reason: Optional[str] = None


def plan_for(cfg: ModelConfig, shape_name: str, *, allow_swa: bool = True) -> ShapePlan:
    info = INPUT_SHAPES[shape_name]
    variant = "paper"
    skip = None
    if shape_name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        if allow_swa:
            variant = "swa"  # beyond-paper sliding-window variant
        else:
            skip = (
                f"{cfg.arch_id} is full-attention; long_500k needs sub-quadratic "
                "attention (run with --variant swa)"
            )
    return ShapePlan(shape_name, info["kind"], info["seq_len"], info["global_batch"], variant, skip)


def apply_variant(cfg: ModelConfig, plan: ShapePlan) -> ModelConfig:
    if plan.variant == "swa":
        return cfg.with_overrides(sliding_window=SWA_WINDOW)
    return cfg


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, Any]:
    """Meta stand-ins for every model input of the step."""
    Bsz, S = plan.global_batch, plan.seq_len
    extra: dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        extra["frames"] = _meta((Bsz, cfg.encoder_seq, cfg.d_model), cfg.activ_dtype)
    if cfg.family == "vlm":
        extra["patches"] = _meta((Bsz, cfg.num_patches, cfg.d_model), cfg.activ_dtype)
    if plan.kind == "train":
        return {"batch": {"tokens": _meta((Bsz, S), torch.int32),
                          "labels": _meta((Bsz, S), torch.int32), **extra}}
    if plan.kind == "prefill":
        return {"tokens": _meta((Bsz, S), torch.int32), **extra}
    # decode: ONE new token against a seq_len-sized cache/state
    return {
        "cache": create_model(cfg).init_cache(Bsz, S, "meta"),
        "tokens": _meta((Bsz, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }


def params_specs(cfg: ModelConfig) -> Any:
    """The parameters as meta tensors, built from the model's ParamDef
    shapes (``build_params`` draws from a generator, and none lives on
    ``meta``)."""
    spec = create_model(cfg)._spec
    flat = {path: _meta(pd.shape, cfg.param_dtype) for path, pd in L._collect(spec).items()}
    return L._rebuild(spec, flat)
