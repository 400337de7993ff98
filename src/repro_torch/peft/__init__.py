"""Parameter-efficient payload plane (LoRA-style low-rank wire kinds).

Mirror of ``src/repro/peft``. :mod:`repro_torch.peft.lowrank` defines
:class:`LowRankDelta`, the factor-pair wire container;
:mod:`repro_torch.peft.stage` registers the ``lora[:rank]`` pipeline
stage. The stage module is not imported here:
``repro_torch.core.serialization`` imports this package for the wire
kind, and the stage imports ``repro_torch.core.pipeline``, so importing
it at package level would close that cycle. ``repro_torch.core.pipeline``
imports the stage module itself, at its bottom, so the ``lora`` stage is
registered wherever the pipeline registry is in use.
"""
from repro_torch.peft.lowrank import LowRankDelta

__all__ = ["LowRankDelta"]
