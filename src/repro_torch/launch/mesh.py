"""Production meshes.

Mirror of ``src/repro/launch/mesh.py``. Single pod: (data=16, model=16)
= 256 devices. Multi-pod: (pod=2, data=16, model=16) = 512; the ``pod``
axis is the federation axis: each pod holds one FL site's model replica,
and cross-pod collectives carry the (quantized) FL round.

Functions, not module constants: importing this module initialises no
process group. Each mesh is a ``torch.distributed`` ``DeviceMesh`` over
the process group the caller has initialised, whose world size must be
the mesh's device count (the dry run's is a fake group of 256 or 512
ranks, :func:`repro_torch.launch.dryrun.fake_process_group`).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str) -> DeviceMesh:
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over as many ranks as the group has (tests)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _mesh((data, model), ("data", "model"), device_type)
