"""Architecture config registry.

Mirror of ``src/repro/configs/base.py``: every assigned architecture, in
the reference's order. Each module defines ``CONFIG`` (the full-scale
spec, citing its source) and ``SMOKE_OVERRIDES`` (the reduced variant the
CPU tests use).
"""
from __future__ import annotations

import importlib

from repro_torch.models.base import ModelConfig

ARCH_IDS: list[str] = [
    "xlstm-125m",
    "stablelm-1.6b",
    "dbrx-132b",
    "whisper-small",
    "llama4-scout-17b-a16e",
    "qwen1.5-0.5b",
    "recurrentgemma-2b",
    "granite-8b",
    "phi-3-vision-4.2b",
    "qwen2.5-32b",
    # the paper's own experiment model
    "llama3.2-1b",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch {arch_id!r}; valid: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    get_config(arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG.with_overrides(**mod.SMOKE_OVERRIDES)


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
