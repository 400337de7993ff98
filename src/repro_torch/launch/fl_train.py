"""Federated training with one process per pod — the mesh view of the paper.

Mirror of ``src/repro/launch/fl_train.py``. Each pod is one FL site and
one rank of a ``torch.distributed`` process group (the reference's
``pod`` mesh axis): it holds a model replica and its own AdamW state,
runs ``local_steps`` of AdamW on its own (non-IID-able) data, then the
round closes with a cross-pod aggregation of the parameter delta:

    --agg fp32        paper-faithful full-precision aggregation (all_reduce mean)
    --agg int8        quantized collective (blockwise-int8 wire, fp32 agg)
    --agg int8-bucket quantized + bucketed (streaming) collective

Both ranks on one card (gloo moves the gathered bytes through the host),
or on the CPU with the plain PyTorch versions of the kernels::

    PYTHONPATH=src python -m repro_torch.launch.fl_train --arch qwen1.5-0.5b \\
      --rounds 5 --local-steps 2 --pods 2 --agg int8 --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.fl_train --smoke --device cpu

The entry point spawns ``--pods`` ranks (a ``file://`` rendezvous in a
temporary directory); started by ``torchrun``, each process joins the
group instead. It runs on the card unless ``--device`` names another
device, and raises without CUDA. ``--backend`` defaults to ``nccl`` on
CUDA, which needs one card per rank, and ``gloo`` on the CPU; a choice
that cannot work raises. Rank 0 reports its own loss, as the reference
reports pod 0's (its ``out_specs=P()`` output reads the first device).
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
from collections.abc import Callable
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import collectives as C
from repro_torch.data import dirichlet_partition
from repro_torch.kernels import _build
from repro_torch.models import create_model
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.device import disable_tf32, resolve_device
from repro_torch.utils.trees import params_from_flat, tree_leaves

AGGS = ("fp32", "int8", "int8-bucket")
#: the bucket of ``--agg int8-bucket`` (the reference's, 8 MiB of fp32)
BUCKET_BYTES = 8 << 20
#: how long a rank waits for the others at a collective
TIMEOUT = timedelta(minutes=10)


def resolve_backend(backend: Optional[str], device: torch.device, world: int) -> str:
    """The process group's backend: ``nccl`` by default on CUDA, ``gloo``
    on the CPU. Raises for a choice that cannot work — it never switches
    quietly."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "gloo":
        return backend
    if backend != "nccl":
        raise ValueError(f"unknown backend {backend!r}; choose nccl or gloo")
    if device.type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA tensors, not {device.type}; "
                         "use --backend gloo")
    if not dist.is_nccl_available():
        raise RuntimeError("this PyTorch build has no NCCL; use --backend gloo")
    cards = torch.cuda.device_count()
    if (device.index is not None and world > 1) or world > cards:
        raise ValueError(f"the nccl backend needs one card per rank: {world} ranks on "
                         f"{device if device.index is not None else f'{cards} cards'}; "
                         "--backend gloo runs several ranks on one card")
    return backend


def rank_device(device: Any, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:<rank mod cards>`` for a bare
    ``cuda`` (the default), else the device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _map2(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def make_fl_round(model: Any, *, local_steps: int, lr: float, agg: str,
                  group: Optional[Any] = None) -> Callable:
    """One federated round on this rank: ``local_steps`` AdamW steps on
    the rank's own batches (params and AdamW state updated in place),
    then the cross-pod mean of the fp32 delta with the configured wire
    format, and ``start + delta``. Returns ``fl_round(params, opt_state,
    batches) -> (params, opt_state, mean loss)``. With tracing on,
    ``fl.local_train`` spans the local steps."""
    if agg not in AGGS:
        raise ValueError(f"unknown aggregation {agg!r}; choose one of {AGGS}")

    def local_train(params, opt_state, batches):
        leaves = tree_leaves(params)
        losses = []
        for batch in batches:
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            adamw_update(params, list(grads), opt_state, lr)
            losses.append(loss.detach())
            del grads
        return params, opt_state, torch.stack(losses)

    def fl_round(params, opt_state, batches):
        with torch.no_grad():
            start = _map2(lambda p, _: p.detach().clone(), params, params)
        with obs_trace.span("fl.local_train", "fl", steps=local_steps):
            params, opt_state, losses = local_train(params, opt_state, batches)
        with torch.no_grad():
            delta = _map2(lambda new, old: new.detach().to(torch.float32)
                          - old.to(torch.float32), params, start)
            if agg == "fp32":
                delta = C.fp32_fedavg_tree(delta, group)
            elif agg == "int8":
                delta = C.quantized_fedavg_tree(delta, group)
            else:
                delta = C.quantized_fedavg_tree(delta, group, bucket_bytes=BUCKET_BYTES)
            for p, s, d in zip(tree_leaves(params), tree_leaves(start), tree_leaves(delta)):
                p.copy_(s.to(torch.float32).add_(d).to(p.dtype))
        return params, opt_state, losses.mean()

    return fl_round


def run(args: argparse.Namespace, *, rank: int = 0, world: int = 1,
        init_params: Optional[dict[str, Any]] = None,
        group: Optional[Any] = None) -> dict[str, Any]:
    """This rank's part of ``args.rounds`` federated rounds, inside an
    initialised process group of ``args.pods`` ranks. Rank ``p`` samples
    only pod ``p``'s dataset of the reference's Dirichlet partition (each
    has its own generator, so it draws the reference's tokens for that
    pod). ``init_params`` replaces the seeded init (a flat dict, e.g. the
    reference's numpy weights). Returns this rank's per-round losses
    (``history``), round wall times, and its final params and AdamW
    state."""
    if world != args.pods:
        raise ValueError(f"{world} ranks for {args.pods} pods")
    device = rank_device(args.device, rank)
    if device.type == "cuda":
        disable_tf32()
    # remat off, as in fl/job.py: a local step peaks on AdamW's state
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = create_model(cfg.with_overrides(remat=False))
    if init_params is None:
        params = model.init(args.seed, device)
    else:
        params = params_from_flat(model, init_params, device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt_state = adamw_init(params)
    data = dirichlet_partition(cfg.vocab_size, args.seq, args.pods,
                               alpha=args.alpha, seed=args.seed)[rank]
    round_fn = make_fl_round(model, local_steps=args.local_steps, lr=args.lr,
                             agg=args.agg, group=group)
    history, walls = [], []
    for rnd in range(args.rounds):
        # sample once per (pod, step), as the reference does, so tokens
        # and labels stay paired
        batches = [{k: torch.as_tensor(v, device=device).long()
                    for k, v in data.sample(args.batch).items()}
                   for _ in range(args.local_steps)]
        t0 = time.perf_counter()
        with obs_trace.span("fl.round", "fl", round=rnd, agg=args.agg):
            params, opt_state, loss = round_fn(params, opt_state, batches)
            loss = float(loss)
        walls.append(time.perf_counter() - t0)
        history.append(loss)
        if rank == 0:
            print(f"round {rnd:3d} agg={args.agg:11s} loss={loss:.4f} ({walls[-1]:.1f}s)")
    return {"history": history, "round_wall_s": walls, "params": params,
            "opt_state": opt_state}


def _train_rank(rank: int, world: int, args: argparse.Namespace,
                init_params: Optional[dict[str, Any]] = None) -> dict[str, Any]:
    out = run(args, rank=rank, world=world, init_params=init_params)
    return {"history": out["history"], "round_wall_s": out["round_wall_s"]}


def _rank_entry(rank: int, world: int, backend: str, init_method: str, out_dir: str,
                args: argparse.Namespace, rank_fn: Callable, rank_args: tuple) -> None:
    device = rank_device(args.device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        result = rank_fn(rank, world, args, *rank_args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def launch(args: argparse.Namespace, rank_fn: Optional[Callable] = None,
           rank_args: tuple = ()) -> list[Any]:
    """Spawn ``args.pods`` ranks in one process group and run
    ``rank_fn(rank, world, args, *rank_args)`` in each (default: the
    federated rounds of :func:`run`); returns each rank's result, which
    must pickle (keep it on the host). ``rank_fn`` must be importable by
    name. On CUDA the kernels are built here first, so each rank only
    loads the cached library. A rank that raises makes this raise."""
    world, device = args.pods, resolve_device(args.device)
    backend = resolve_backend(args.backend, device, world)
    if device.type == "cuda":
        _build.build()
    with tempfile.TemporaryDirectory(prefix="fl_train_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_entry, nprocs=world, join=True,
                 args=(world, backend, init_method, tmp, args, rank_fn or _train_rank,
                       tuple(rank_args)))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--agg", choices=AGGS, default="int8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default: nccl on CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = rank_device(args.device, rank)
        backend = resolve_backend(args.backend, resolve_device(args.device), world)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            history = run(args, rank=rank, world=world)["history"]
        finally:
            dist.destroy_process_group()
        if rank != 0:
            return
    else:
        history = launch(args)[0]["history"]
    print(f"final loss {history[-1]:.4f} (start {history[0]:.4f})")


if __name__ == "__main__":
    main()
