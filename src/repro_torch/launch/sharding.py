"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

Mirror of ``src/repro/launch/sharding.py``. Every model parameter carries
a tuple of logical axis names (from its ParamDef); these rules map them
to mesh axes with an automatic fallback: if a dim is not divisible by the
product of its mapped mesh axes, the mapping is dropped (replicated), so
odd head counts (whisper 12H, recurrentgemma 10H) and batch=1 decode
shapes shard cleanly everywhere.

:func:`spec_for` gives the reference's ``PartitionSpec`` entries as a
tuple (one entry per tensor dim: ``None``, a mesh axis, or a tuple of
mesh axes). :func:`placements` turns them into DTensor placements, one
per mesh dim. A mesh here is anything with ``mesh_dim_names`` and
``shape`` (a ``torch.distributed.device_mesh.DeviceMesh``).
"""
from __future__ import annotations

import math
from collections.abc import Sequence
from typing import Any, Optional

from torch.distributed.tensor import Placement, Replicate, Shard

from repro_torch.models import base as B

Entry = Optional[str | tuple[str, ...]]

# rule set: logical axis -> mesh axes (tried in order, dropped if indivisible)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    B.BATCH: ("pod", "data"),
    B.VOCAB: ("model",),
    B.EMBED: ("data",),      # FSDP: weights' d_model dim sharded over data
    B.Q_FEAT: ("model",),
    B.KV_FEAT: ("model",),
    B.MLP: ("model",),
    B.EXPERT: ("model",),
    B.STATE: ("model",),
    B.SEQ: (),
    B.LAYER: (),
    B.CONV: (),
}

# variant without FSDP (pure tensor-parallel; small models replicate embed)
TP_ONLY_RULES = dict(DEFAULT_RULES, **{B.EMBED: ()})


def axis_sizes(mesh: Any) -> dict[str, int]:
    """``{mesh axis name: size}``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh: Any,
    rules: dict[str, tuple[str, ...]],
) -> tuple[Entry, ...]:
    """The PartitionSpec entries of one tensor, honoring divisibility: a
    mesh axis is used at most once, and trailing mesh axes are dropped
    until the dim divides their product."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries: list[Entry] = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in rules:
            entries.append(None)
            continue
        mesh_axes = [m for m in rules[ax] if m in sizes and m not in used]
        while mesh_axes and dim % math.prod(sizes[m] for m in mesh_axes):
            mesh_axes = mesh_axes[:-1]
        if mesh_axes:
            used.update(mesh_axes)
            entries.append(tuple(mesh_axes) if len(mesh_axes) > 1 else mesh_axes[0])
        else:
            entries.append(None)
    return tuple(entries)


def placements(entries: Sequence[Entry], mesh: Any) -> tuple[Placement, ...]:
    """DTensor placements for ``entries``: for each mesh dim, ``Shard(d)``
    if tensor dim ``d`` is split over it, else ``Replicate()``. DTensor
    splits a dim held by several mesh dims in mesh order, the first mesh
    dim outermost, as a PartitionSpec's tuple does when its axes are in
    mesh order; any other order is refused."""
    names = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate() for _ in names]
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(m) for m in group]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {group} of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], entries: Sequence[Entry], mesh: Any) -> tuple[int, ...]:
    """One device's shard shape under ``entries`` (every split divides)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, entries):
        group = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(dim // math.prod(sizes[m] for m in group))
    return tuple(out)


def tree_shardings(
    shapes_tree: Any,
    axes_tree: Any,
    mesh: Any,
    rules: Optional[dict[str, tuple[str, ...]]] = None,
) -> Any:
    """shapes_tree: nested dict of tensors (meta or real); axes_tree: the
    same structure of logical-axis tuples -> the same structure of
    PartitionSpec entries."""
    rules = rules or DEFAULT_RULES
    if isinstance(shapes_tree, dict):
        return {k: tree_shardings(v, axes_tree[k], mesh, rules) for k, v in shapes_tree.items()}
    return spec_for(shapes_tree.shape, axes_tree, mesh, rules)


def batch_sharding(mesh: Any, shape: Sequence[int], rules=None) -> tuple[Entry, ...]:
    """Standard activation sharding: dim0 = batch over (pod, data), with
    divisibility fallback (batch=1 decode shapes replicate)."""
    rules = rules or DEFAULT_RULES
    axes = (B.BATCH,) + (None,) * (len(shape) - 1)
    return spec_for(shape, axes, mesh, rules)


def replicated(mesh: Any) -> tuple[Entry, ...]:
    """The entries of a tensor every device holds whole (``P()``)."""
    del mesh
    return ()
