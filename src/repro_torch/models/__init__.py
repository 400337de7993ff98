"""Model substrate: the dense ``DecoderLM`` family and the xLSTM (``ssm``)."""
from typing import Any

from repro_torch.models.base import ModelConfig
from repro_torch.models.ssm import XLSTMModel
from repro_torch.models.transformer import DecoderLM


def create_model(cfg: ModelConfig) -> Any:
    """Family dispatch, as the reference's ``create_model``; the port
    builds the dense and ssm families so far, and every other family
    raises."""
    if cfg.family == "dense":
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return XLSTMModel(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to repro_torch yet (ROADMAP A12)")


__all__ = ["ModelConfig", "DecoderLM", "XLSTMModel", "create_model"]
