"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when CUDA is absent — they never
carry on quietly on the CPU.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


def resolve_device(device: Optional[Any] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and found no CUDA device; "
                'pass device="cpu" to run the plain PyTorch versions on the CPU'
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
