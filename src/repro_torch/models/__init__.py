"""Model substrate: every family of the reference — the decoder
(``dense``, ``moe``, ``vlm``), the xLSTM (``ssm``), the RG-LRU hybrid
(``hybrid``) and the encoder-decoder (``encdec``)."""
from typing import Any

from repro_torch.models.base import ModelConfig, active_param_count, param_count
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.rglru import GriffinModel
from repro_torch.models.ssm import XLSTMModel
from repro_torch.models.transformer import DecoderLM


def create_model(cfg: ModelConfig) -> Any:
    """Family dispatch, as the reference's ``create_model``: 'vlm'
    backbones are decoders with a patch-embedding prefix, and the
    frontends (patches, audio frames) are stubs."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return XLSTMModel(cfg)
    if cfg.family == "hybrid":
        return GriffinModel(cfg)
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = [
    "ModelConfig",
    "create_model",
    "param_count",
    "active_param_count",
    "DecoderLM",
    "XLSTMModel",
    "GriffinModel",
    "EncDecModel",
]
