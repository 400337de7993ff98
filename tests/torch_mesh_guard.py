"""A check, on torch 2.13 (the CPU tests' torch), for the DTensor ops
that torch 2.11 (the card machine's) refuses on a mesh.

torch 2.13 carries each of these through (a flatten of two sharded dims
becomes a ``_StridedShard``; a pointwise op picks another strategy), so a
dry run that counts here can still fail there. :class:`MeshGuard` runs a
step and records, per DTensor op:

* ``flatten``: a ``view`` / ``_unsafe_view`` / ``reshape`` that merges
  dims of which any but the first is sharded (2.11: "Attempted to flatten
  multiple dimensions, with dimension N being sharded");
* ``split``: one that splits a sharded dim whose first piece the mesh
  dims sharding it do not divide (2.11: "Attempted to split the sharded
  dimension N into multiple subdimensions");
* ``shard-to-partial``: a redistribution DTensor performs from ``Shard``
  to ``Partial`` on one mesh dim, and an ``add`` / ``sub`` that would ask
  for one under 2.11's pointwise rule: it follows the input with the most
  shards (then the most dims, the first on a tie) and asks the other
  input for the followed one's partial sums, which a sharded input cannot
  give (2.11: "redistribute from S(0) to P(sum) not supported yet").

The rules are 2.11's view propagation (its ``Flatten`` / ``Split``
checks) and its pointwise strategy, read from the placements the ops see
here; ``tests/test_torch_dryrun_mesh_guard*.py`` hold the model steps of
every arch to them. Both torches must count the same pairs.
"""
from __future__ import annotations

import contextlib
import math
import traceback
from typing import Any, Iterator

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
VIEWS = (aten.view.default, aten._unsafe_view.default, aten.reshape.default)
LINEAR = (aten.add.Tensor, aten.add_.Tensor, aten.sub.Tensor, aten.sub_.Tensor)


def _sharding(x: DTensor, dim: int) -> int:
    """The product of the mesh dims that shard tensor dim ``dim`` of ``x``."""
    return math.prod(n for p, n in zip(x.placements, x.device_mesh.shape)
                     if isinstance(p, Shard) and p.dim == dim)


def _shards(x: DTensor) -> int:
    return math.prod(n for p, n in zip(x.placements, x.device_mesh.shape)
                     if isinstance(p, Shard))


def _where() -> str:
    return "".join(line for line in traceback.format_stack(limit=40)
                   if "repro_torch" in line)


class MeshGuard(TorchDispatchMode):
    """Records the ops torch 2.11 refuses (see the module docstring) in
    ``found``: (kind, op, shapes, placements, where)."""

    def __init__(self) -> None:
        super().__init__()
        self.found: list[tuple[str, str, Any, Any, str]] = []

    def _record(self, kind: str, func: Any, tensors: list[DTensor]) -> None:
        self.found.append((kind, str(func), [tuple(t.shape) for t in tensors],
                           [t.placements for t in tensors], _where()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in VIEWS and isinstance(args[0], DTensor):
            self._check_view(func, args[0], list(args[1]))
        if func in LINEAR and all(isinstance(a, DTensor) for a in args[:2]):
            self._check_linear(func, args[0], args[1])
        return func(*args, **(kwargs or {}))

    def _check_view(self, func: Any, x: DTensor, shape: list[int]) -> None:
        from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split, view_groups

        if -1 in shape:
            shape[shape.index(-1)] = x.numel() // -math.prod(shape)

        def visit(cmd: Any) -> None:
            if isinstance(cmd, Flatten):
                if any(isinstance(d, InputDim) and _sharding(x, d.input_dim) > 1
                       for d in cmd.input_dims[1:]):
                    self._record("flatten", func, [x])
                for d in cmd.input_dims:
                    visit(d)
            elif isinstance(cmd, Split):
                visit(cmd.input_dim)
                if cmd.split_id == 0 and isinstance(cmd.input_dim, InputDim):
                    n = _sharding(x, cmd.input_dim.input_dim)
                    if n > 1 and cmd.group_shape[0] % n:
                        self._record("split", func, [x])

        for cmd in view_groups(tuple(x.shape), tuple(shape)):
            visit(cmd)

    def _check_linear(self, func: Any, a: DTensor, b: DTensor) -> None:
        followed, other = (b, a) if (_shards(b), b.ndim) > (_shards(a), a.ndim) else (a, b)
        if any(isinstance(p, Partial) and isinstance(q, Shard)
               for p, q in zip(followed.placements, other.placements)):
            self._record("shard-to-partial", func, [followed, other])

    @contextlib.contextmanager
    def redistributions(self, monkeypatch: Any) -> Iterator[None]:
        """Also record each redistribution DTensor performs from ``Shard``
        to ``Partial`` (its own, inside ops, and explicit ones)."""
        from torch.distributed.tensor import _api, _dispatch, _redistribute

        original = _redistribute.redistribute_local_tensor

        def watched(local, current, target, *args, **kwargs):
            if any(isinstance(p, Shard) and isinstance(q, Partial)
                   for p, q in zip(current.placements, target.placements)):
                self.found.append(("shard-to-partial", "redistribute",
                                   [tuple(current.shape)],
                                   [current.placements, target.placements], _where()))
            return original(local, current, target, *args, **kwargs)

        for module in (_redistribute, _dispatch, _api):
            monkeypatch.setattr(module, "redistribute_local_tensor", watched)
        yield


def run_guarded(step: Any, args: tuple, mesh: Any, monkeypatch: Any) -> MeshGuard:
    """Run the dry run's ``step(*args)`` on ``mesh`` (under the models'
    sharding context, DTensor's implicit replication and the cut time
    loops, as the count runs it) inside a :class:`MeshGuard`."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models.ssm import cut_time_loops

    guard = MeshGuard()
    L.set_sharding_context(mesh, SH.DEFAULT_RULES)
    try:
        with cut_time_loops(None), implicit_replication(), \
                guard.redistributions(monkeypatch), guard:
            step(*args)
    finally:
        L.set_sharding_context(None, None)
    return guard


def report(found: list) -> str:
    return "\n".join(f"{kind} {op} {shapes} {placements}\n{where}"
                     for kind, op, shapes, placements, where in found[:5])


#: tests/test_dryrun_small.py's shrunken (seq_len, global_batch)
SMALL = {"train_4k": (128, 8), "prefill_32k": (256, 4), "decode_32k": (256, 8)}


def small_plan(cfg: Any, shape: str) -> tuple[Any, Any]:
    """``cfg`` and its plan at ``shape``, cut to :data:`SMALL`."""
    from repro_torch.launch.specs import ShapePlan, apply_variant, plan_for

    seq, batch = SMALL[shape]
    plan = plan_for(cfg, shape)
    plan = ShapePlan(plan.shape_name, plan.kind, seq, batch, plan.variant)
    return apply_variant(cfg, plan), plan


def guard_smoke_steps(arch: str, mesh: Any, monkeypatch: Any) -> list:
    """What :class:`MeshGuard` finds in ``arch``'s smoke-width train,
    prefill and decode steps (:data:`SMALL`) on ``mesh``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun

    found = []
    for shape in SMALL:
        cfg, plan = small_plan(get_smoke_config(arch), shape)
        step, args = dryrun.build_step(cfg, plan, mesh)
        found += [(f"{shape}: {kind}", *rest)
                  for kind, *rest in run_guarded(step, args, mesh, monkeypatch).found]
    return found
