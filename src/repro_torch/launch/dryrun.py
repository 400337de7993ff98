"""Dry run: count every (architecture x input shape) step on the ``meta``
device, with no device memory and no data, and emit its roofline terms.

Mirror of ``src/repro/launch/dryrun.py``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                # one chip
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod     # 2x16x16

The step is the port's own: ``launch/train.py::make_train_step`` with
AdamW, or the model's ``prefill`` / ``decode_step``, run eagerly on meta
tensors (the reference lowers and compiles its jitted step instead). A
:class:`StepCounter` dispatch mode counts, per device:

* FLOPs, by ``torch.utils.flop_counter``'s formulas (the matrix products,
  as the reference's HLO counter counts dots);
* bytes: each aten op's inputs and outputs, views counted as free. This
  is the eager traffic the port has, op by op, not the fused traffic a
  compiler would leave: it is an upper bound on what a fused step moves.
  On ``meta`` the kernels' plain versions run (B7's masked softmax, B8's
  step loop), so attention's bytes are the softmax's, not the flash
  kernel's;
* the argument, output and peak bytes, the peak being the high-water
  mark of live meta storage;
* collectives, on a mesh: the step runs on DTensors over a fake process
  group (``--mesh``), with the parameters, optimizer state, inputs and
  cache placed by ``launch/sharding.py``'s rules; the collectives DTensor
  issues are counted (``CommDebugMode`` and this counter must agree) and
  their wire bytes follow the reference's ring model. A redistribution
  DTensor inserts inside an op, where no rule asked for one, is reported
  per op (``implicit_redistributions``).

A time loop on meta (xlstm-125m's sLSTM recurrence and mLSTM chunks) runs
only a few of its steps (``models.ssm.cut_time_loops``), and its count is
one step times the trip count (:func:`count_step`; the report lists
``trip_counts``).

The step runs in the config's own dtype (fp32, as the port trains and
serves on the card; the reference's dry run casts to bf16), and the peaks
are those of the card named by ``--card`` (default: the H100 in
``launch/roofline.py``) for that dtype with TF32 off, as the port runs.
Results are written only with ``--out DIR`` (e.g.
``experiments/dryrun_torch/``, which git ignores).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import weakref
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.specs import (
    INPUT_SHAPES,
    ShapePlan,
    apply_variant,
    input_specs,
    params_specs,
    plan_for,
)
from repro_torch.launch.train import make_train_step
from repro_torch.models import create_model
from repro_torch.models import layers as L
from repro_torch.models.ssm import CUT_STEPS, cut_time_loops
from repro_torch.optim.adamw import AdamWState
from repro_torch.utils.trees import tree_leaves

DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

_FUNCOL = torch.ops._c10d_functional
#: DTensor's collectives -> (the reference's kind, index of the group-size
#: argument or None to read it from the group name, the last argument)
_COLLECTIVES = {
    _FUNCOL.all_gather_into_tensor: ("all-gather", 1),
    _FUNCOL.reduce_scatter_tensor: ("reduce-scatter", 2),
    _FUNCOL.all_reduce: ("all-reduce", None),
    _FUNCOL.all_to_all_single: ("all-to-all", None),
    _FUNCOL.broadcast: ("broadcast", None),
    torch.ops._dtensor.shard_dim_alltoall: ("all-to-all", None),
}
#: ops that move no bytes: results that alias their input, and allocations
_FREE = {torch.ops.aten._unsafe_view, torch.ops.aten.empty, torch.ops.aten.empty_strided,
         torch.ops.aten.empty_like, torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
         torch.ops.aten.lift_fresh, _FUNCOL.wait_tensor}
#: in-place ops that write their first argument without reading it
_WRITE_ONLY = {torch.ops.aten.copy_, torch.ops.aten.fill_, torch.ops.aten.zero_}


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _hashable(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        if value.device.type != "meta":
            raise TypeError("not a meta tensor")
        return ("tensor", tuple(value.shape), value.stride(), value.dtype)
    if isinstance(value, (list, tuple)):
        return tuple(_hashable(v) for v in value)
    if isinstance(value, dict):
        return tuple((k, _hashable(v)) for k, v in sorted(value.items()))
    hash(value)
    return value


def _meta_like(record: Any) -> Any:
    if isinstance(record, list):
        return tuple(_meta_like(r) for r in record)
    shape, stride, dtype = record
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _record(out: Any) -> Any:
    if isinstance(out, (list, tuple)):
        return [_record(o) for o in out]
    if not isinstance(out, torch.Tensor) or out.device.type != "meta":
        raise TypeError("not a meta tensor")
    return (tuple(out.shape), out.stride(), out.dtype)


def _group_size(op: Any, args: tuple) -> int:
    kind, idx = _COLLECTIVES[op]
    if idx is not None:
        return int(args[idx])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class StepCounter(TorchDispatchMode):
    """Counts, per device, the FLOPs, bytes, collectives and peak live
    storage of everything run under it (see the module docstring). Ops on
    DTensors are left to DTensor (``NotImplemented``), so only the local
    ops each device runs are counted."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, dict[str, float]] = {}
        self.implicit: dict[str, dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._registry = FlopCounterMode(display=False).flop_registry
        self._shapes: dict[Any, Any] = {}
        self._dtensor_op: Optional[str] = None
        self._computed = True

    def track(self, tree: Any) -> int:
        """Count ``tree``'s tensors as live (arguments made before the run);
        returns their bytes on this device."""
        return sum(self._track(_local(t)) for t in _tensors(tree))

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _call(self, func, packet, args: tuple, kwargs: dict) -> Any:
        """``func(*args, **kwargs)``; for an op on meta tensors that neither
        aliases nor mutates, the output's shapes are remembered by the
        inputs' shapes, strides and dtypes and the other arguments, and a
        repeat gets fresh meta tensors of those shapes: the meta kernels
        are Python, and a model repeats each layer's shapes."""
        if func.is_view or func._schema.is_mutable or packet in _COLLECTIVES or packet in _FREE:
            return func(*args, **kwargs)
        try:
            key = (func, _hashable(args), _hashable(kwargs))
        except TypeError:       # a non-meta tensor, or an argument with no hash
            return func(*args, **kwargs)
        if key in self._shapes:
            return _meta_like(self._shapes[key])
        out = func(*args, **kwargs)
        try:
            self._shapes[key] = _record(out)
        except TypeError:       # not all meta tensors: run it each time
            pass
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op, self._computed = str(func), False
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor deriving an op's global output shape: no device runs it
            return func(*args, **kwargs)
        if not all(t.device.type == "meta" for t in _tensors((args, kwargs))):
            # host-side bookkeeping (DTensor's, on the mesh's CPU tensors)
            return func(*args, **kwargs)
        packet = func._overloadpacket
        out = self._call(func, packet, args, kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if packet in _COLLECTIVES:
            kind = _COLLECTIVES[packet][0]
            size = sum(_nbytes(t) for t in outs)
            n = _group_size(packet, args)
            s = self.collectives.setdefault(
                kind, {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0})
            s["count"] += 1
            s["result_bytes"] += size
            s["wire_bytes"] += RL.collective_wire_bytes(kind, size, n)
            if not self._computed:   # inside a DTensor op: its own redistribution
                per_op = self.implicit.setdefault(self._dtensor_op, {})
                per_op[kind] = per_op.get(kind, 0) + 1
        else:
            self._computed = True
        if packet in self._registry:
            self.flops += self._registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or packet in _FREE):
            ins = _tensors((args, kwargs))
            if packet in _WRITE_ONLY:
                ins = ins[1:]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


# ---------------------------------------------------------------------------
# the fake process group and sharded meta stand-ins
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A process group of ``world_size`` fake ranks (this process is rank
    0; collectives return at once), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...]):
    """The production mesh ((16, 16), (2, 16, 16)) or a debug mesh ((data,
    model) or (pod, data, model)) over the current group, with CPU as its
    device type: the local shards are meta tensors."""
    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu")
    return make_debug_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else 0,
                           device_type="cpu")


def _shard(t: torch.Tensor, entries: tuple, mesh: Any) -> torch.Tensor:
    """``t`` (meta) as a DTensor placed by ``entries`` on ``mesh``, its
    local shard a meta tensor."""
    local = torch.empty(SH.local_shape(t.shape, entries, mesh), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, SH.placements(entries, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def _shard_tree(tree: Any, entries: Any, mesh: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _shard_tree(v, entries[k], mesh) for k, v in tree.items()}
    return _shard(tree, entries, mesh)


def _batch_tree(tree: Any, mesh: Any, rules: dict) -> Any:
    if isinstance(tree, dict):
        return {k: _batch_tree(v, mesh, rules) for k, v in tree.items()}
    return _shard(tree, SH.batch_sharding(mesh, tree.shape, rules), mesh)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@functools.cache
def register_missing_strategies() -> None:
    """Give DTensor the sharding strategies a step needs and it lacks (on
    torch 2.11 and 2.13 alike, through the same public
    ``register_sharding``): ``aten.log_sigmoid_backward``, which the
    xLSTM's ``F.logsigmoid`` reaches in the backward, is pointwise in its
    three inputs (the gradient, the input and the forward's buffer, of the
    input's shape on ``meta``), so all three replicated or all three
    sharded on one dim. Registered once a process; DTensor's table is
    global."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        del grad_output
        whole = tuple(buffer.shape) == tuple(x.shape)   # an empty buffer stays replicated
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(x.ndim):
            out.append(([Shard(d)], [Shard(d), Shard(d), Shard(d) if whole else Replicate()]))
        return out


def build_step(cfg, plan: ShapePlan, mesh=None, rules=None):
    """Returns (step_fn, args): the step of ``plan.kind`` and its meta
    arguments, DTensors placed by ``rules`` when ``mesh`` is given."""
    rules = rules or SH.DEFAULT_RULES
    model = create_model(cfg)
    params = params_specs(cfg)
    specs = input_specs(cfg, plan)
    if mesh is not None:
        register_missing_strategies()
        p_entries = SH.tree_shardings(params, model.param_axes(), mesh, rules)
        params = _shard_tree(params, p_entries, mesh)

    if plan.kind == "train":
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        moments = [params_specs(cfg) for _ in range(2)]
        if mesh is not None:
            moments = [_shard_tree(m, p_entries, mesh) for m in moments]
        opt_state = AdamWState(torch.zeros((), dtype=torch.int32, device="meta"), *moments)
        batch = specs["batch"]
        batch = {k: v.long() if k in ("tokens", "labels") else v for k, v in batch.items()}
        if mesh is not None:
            batch = _batch_tree(batch, mesh, rules)
        lr = torch.full((), 1e-4, dtype=torch.float32, device="meta")
        step = make_train_step(model, lambda _step: lr)
        return step, (params, opt_state, batch)

    if plan.kind == "prefill":
        inputs = specs if mesh is None else _batch_tree(specs, mesh, rules)

        def prefill_step(params, inputs):
            with torch.no_grad():
                extra = [inputs[k] for k in ("frames", "patches") if k in inputs]
                return model.prefill(params, inputs["tokens"], *extra)

        return prefill_step, (params, inputs)

    cache, tokens = specs["cache"], specs["tokens"]
    if mesh is not None:
        cache = _shard_tree(cache, SH.tree_shardings(cache, model.cache_axes(), mesh, rules),
                            mesh)
        tokens = _batch_tree(tokens, mesh, rules)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos)

    # the last slot of the cache: attention reads all of it
    return serve_step, (params, cache, tokens, plan.seq_len - 1)


def _run_counted(step, args, mesh) -> dict[str, Any]:
    counter = StepCounter()
    argument_bytes = counter.track(args)
    if mesh is None:
        with counter:
            out = step(*args)
    else:
        with CommDebugMode() as comm, counter, implicit_replication():
            out = step(*args)
        comm_count = sum(comm.get_comm_counts().values())
        ours = sum(s["count"] for s in counter.collectives.values())
        if comm_count != ours:
            raise RuntimeError(f"CommDebugMode saw {comm_count} collectives, the counter {ours}")
    out_tensors = {id(_local(t).untyped_storage()): _local(t) for t in _tensors(out)}
    return {"flops": counter.flops, "bytes": counter.bytes, "collectives": counter.collectives,
            "implicit_redistributions": counter.implicit,
            "memory": {"argument_bytes": float(argument_bytes),
                       "output_bytes": float(sum(t.untyped_storage().nbytes()
                                                 for t in out_tensors.values())),
                       "peak_bytes": float(counter.peak)}}


def _loop_total(base: Any, longers: list[tuple[int, Any]]) -> Any:
    """``base`` + the sum over (n, longer) of (n - CUT_STEPS) (longer -
    base), leaf by leaf (a key missing from a tree counts 0)."""
    if isinstance(base, dict) or any(isinstance(t, dict) for _, t in longers):
        base = base if isinstance(base, dict) else {}
        longers = [(n, t if isinstance(t, dict) else {}) for n, t in longers]
        keys = set(base) | {k for _, t in longers for k in t}
        return {k: _loop_total(base.get(k, 0.0), [(n, t.get(k, 0.0)) for n, t in longers])
                for k in keys}
    return base + sum((n - CUT_STEPS) * (longer - base) for n, longer in longers)


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, float]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _count_once(cfg, plan: ShapePlan, mesh, rules, longer: Optional[dict[int, int]]):
    step, args = build_step(cfg, plan, mesh, rules)
    if mesh is not None:
        L.set_sharding_context(mesh, rules or SH.DEFAULT_RULES)
    try:
        with cut_time_loops(longer) as cut:
            return _run_counted(step, args, mesh), sorted(set(cut))
    finally:
        L.set_sharding_context(None, None)


_LINEAR = ("flops", "bytes", "collectives", "memory")


def count_step(cfg, plan: ShapePlan, mesh=None, rules=None) -> dict[str, Any]:
    """The per-device counts of one step (see the module docstring).

    Each meta time loop is counted as one step times its trip count. A
    first run takes :data:`~repro_torch.models.ssm.CUT_STEPS` (three)
    steps of every loop, then one run per trip count n takes one step more
    of the loops of n steps, and the total adds n - 3 times the difference.
    (On a mesh the first two steps start from a state that is not yet
    placed as the rest are, so the base run takes three.) Every count,
    the peak of live storage included, must then grow linearly: a check
    run takes two steps more of every cut loop, and its counts must be the
    base's plus twice the differences. Where a count does not, the step is
    refused; where the peak does not, it is reported as None, with the
    reason under ``peak_unknown``. (A peak is a high-water mark: on a mesh
    DTensor's temporaries can make it wander from step to step, and then
    no one step times n gives the full loop's.)"""
    if mesh is not None:   # a first run fills DTensor's caches, which do work once
        _count_once(cfg, plan, mesh, rules, None)
    base, trips = _count_once(cfg, plan, mesh, rules, None)
    longers = [(n, _count_once(cfg, plan, mesh, rules, {n: CUT_STEPS + 1})[0]) for n in trips]
    out = {key: _loop_total(base[key], [(n, longer[key]) for n, longer in longers])
           for key in _LINEAR}
    if trips:
        check = _count_once(cfg, plan, mesh, rules, {n: CUT_STEPS + 2 for n in trips})[0]
        want = {key: _loop_total(base[key], [(CUT_STEPS + 2, longer[key])
                                             for _, longer in longers])
                for key in _LINEAR}
        got = dict(_leaves({key: check[key] for key in _LINEAR}))
        want = dict(_leaves(want))
        for name in sorted(set(got) | set(want)):
            if math.isclose(got.get(name, 0.0), want.get(name, 0.0), rel_tol=1e-12):
                continue
            why = (f"the cut time loops ({trips} steps) do not count linearly: {name} is "
                   f"{got.get(name, 0.0)!r} with {CUT_STEPS + 2} steps a loop, not "
                   f"{want.get(name, 0.0)!r}")
            if name != "memory.peak_bytes":
                raise ValueError(why)
            out["memory"]["peak_bytes"] = None
            out["peak_unknown"] = why
    out["implicit_redistributions"] = base["implicit_redistributions"]
    out["trip_counts"] = trips
    return out


def roofline(cfg, plan: ShapePlan, *, arch: str, card: str = DEFAULT_CARD, mesh=None,
             rules=None) -> dict[str, Any]:
    """Count ``plan``'s step of ``cfg`` and return its roofline report as a
    dict, with the implicit redistributions and the count's seconds."""
    t0 = time.perf_counter()
    counts = count_step(cfg, plan, mesh, rules)
    count_s = time.perf_counter() - t0
    mesh_name = "1" if mesh is None else "x".join(str(s) for s in mesh.shape)
    chips = 1 if mesh is None else mesh.size()
    report = RL.analyze(
        arch=arch, shape=plan.shape_name, mesh_name=mesh_name, variant=plan.variant,
        chips=chips, cfg=cfg, kind=plan.kind, seq_len=plan.seq_len,
        global_batch=plan.global_batch, flops=counts["flops"], bytes_accessed=counts["bytes"],
        collectives=counts["collectives"], card=card, dtype=cfg.param_dtype, tf32=False,
        memory_per_device=counts["memory"])
    return {**report.to_dict(), "implicit_redistributions": counts["implicit_redistributions"],
            "trip_counts": counts["trip_counts"], "count_s": count_s,
            **({"peak_unknown": counts["peak_unknown"]} if "peak_unknown" in counts else {})}


def run_one(arch: str, shape_name: str, *, mesh=None, rules=None,
            variant_override: Optional[str] = None, card: str = DEFAULT_CARD,
            out_dir: Optional[str] = None) -> dict[str, Any]:
    """The roofline of ``arch`` at one of :data:`INPUT_SHAPES`, on one chip
    or ``mesh``; written to ``out_dir`` as JSON when given."""
    cfg = get_config(arch)
    plan = plan_for(cfg, shape_name)
    if variant_override:
        plan = ShapePlan(**{**plan.__dict__, "variant": variant_override})
    cfg = apply_variant(cfg, plan)
    out = roofline(cfg, plan, arch=arch, card=card, mesh=mesh, rules=rules)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{out['mesh']}.json")
        with open(path, "w") as fh:
            json.dump(out, fh, indent=2)
    return out


def sweep_pairs() -> list[tuple[str, str]]:
    """``--all``: every arch but llama3.2-1b (as the reference's) x every shape."""
    return [(a, s) for a in ARCH_IDS if a != "llama3.2-1b" for s in INPUT_SHAPES]


def _peak_text(peak: Optional[float]) -> str:
    return "unknown" if peak is None else f"{peak:.3e}"


def summary_line(out: dict[str, Any]) -> str:
    return (f"[ok] {out['arch']:24s} {out['shape']:12s} mesh={out['mesh']:9s} "
            f"variant={out['variant']:5s} flops={out['counted_flops']:.3e} "
            f"bytes={out['counted_bytes']:.3e} wire={out['collective_wire_bytes']:.3e} "
            f"peak={_peak_text(out['memory_per_device']['peak_bytes'])} "
            f"bottleneck={out['bottleneck']} count={out['count_s']:.2f}s")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["1", "16x16"], default="1",
                    help="one chip, or the production mesh over a fake process group")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    ap.add_argument("--variant", choices=["paper", "swa"], default=None)
    ap.add_argument("--card", default=DEFAULT_CARD, help="the card whose peaks bound the step")
    ap.add_argument("--out", default=None, help="write one JSON per pair into this directory")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    RL.peaks_for(args.card)
    shape = (2, 16, 16) if args.multi_pod else tuple(int(x) for x in args.mesh.split("x"))
    pairs = sweep_pairs() if args.all else [(args.arch, args.shape)]
    group = (fake_process_group(math.prod(shape)) if shape != (1,)
             else contextlib.nullcontext())
    failed = []
    t0 = time.perf_counter()
    with group:
        mesh = make_mesh(shape) if shape != (1,) else None
        for arch, shape_name in pairs:
            try:
                out = run_one(arch, shape_name, mesh=mesh, variant_override=args.variant,
                              card=args.card, out_dir=args.out)
            except Exception as exc:  # noqa: BLE001 — the sweep reports every pair
                failed.append((arch, shape_name))
                print(f"[FAIL] {arch} {shape_name}: {type(exc).__name__}: {exc}", flush=True)
                continue
            print(summary_line(out), flush=True)
    print(f"{len(pairs) - len(failed)} of {len(pairs)} pairs counted in "
          f"{time.perf_counter() - t0:.2f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
