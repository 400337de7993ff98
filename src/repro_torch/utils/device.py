"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when CUDA is absent — they never
carry on quietly on the CPU. Those that train turn TF32 off on CUDA
(:func:`disable_tf32`), so matmuls run in fp32 like the reference's.
Kernel wrappers take their plain version for tensors on
:data:`PLAIN_DEVICES`.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

#: the devices whose tensors take a kernel's plain version: the CPU, and
#: ``meta`` (shapes without data, on which no kernel can run: the dry run)
PLAIN_DEVICES = ("cpu", "meta")


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


def disable_tf32() -> None:
    """fp32 matmuls and convolutions on CUDA: no TF32 rounding of inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
