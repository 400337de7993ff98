"""Heterogeneous-fleet demo on the PyTorch port: FedAsync vs tiered
selection under churn, with precision that tracks each client's link.

Eight clients spread from fiber to 3G train a toy least-squares model
while a random availability trace takes them on- and offline (dispatches
to offline clients are deferred; departures mid round trip interrupt and
resume). An AdaptiveQuantizeFilter bound to the runtime's network model
picks each client's wire precision from its simulated link — fiber ships
fp32, 3G ships NF4 — with no per-client configuration.

The message plane (the adaptive quantize filter, dequantize, the
aggregation) runs on ``--device``: the card by default, where the nf4
and blockwise8 links launch the hand-written 4-bit and blockwise8
kernels. The toy clients train in numpy on the host, as
``examples/hetero_federation.py``'s do, so both print the same bytes.

    PYTHONPATH=src python examples/torch/hetero_federation.py
    PYTHONPATH=src python examples/torch/hetero_federation.py --device cpu
"""
import argparse
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.filters import (
    AdaptiveQuantizeFilter,
    DequantizeFilter,
    FilterChain,
    FilterPoint,
    no_filters,
)
from repro_torch.fl import FedAvgAggregator, FLSimulator, SimulationConfig, TrainExecutor
from repro_torch.runtime import (
    FedAsyncPolicy,
    RuntimeConfig,
    TieredPolicy,
    heterogeneous_network,
    random_availability,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_numpy

NUM_CLIENTS, ROUNDS, DIM = 8, 5, 32 * 1024
NAMES = [f"site-{i}" for i in range(NUM_CLIENTS)]


def make_client(name: str, seed: int, w_true: np.ndarray, losses: list) -> TrainExecutor:
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((256, DIM)).astype(np.float32) / np.sqrt(DIM)
    y = X @ w_true

    def train_fn(params, rnd):
        w = as_numpy(params["w"]).astype(np.float32)     # a copy
        # keyed by model version: the append order is wall-clock thread
        # order (nondeterministic), so the report sorts before slicing
        losses.append((rnd, float(np.mean((X @ w - y) ** 2))))
        for _ in range(2):
            w -= 0.8 * (X.T @ (X @ w - y))
        return {"w": w}, len(y), {"loss": float(np.mean((X @ w - y) ** 2))}

    return TrainExecutor(name, train_fn)


def build_filters(network: Any, device: Any):
    filt = AdaptiveQuantizeFilter.from_network(network, budget_s=0.05, device=device)
    server = no_filters()
    server[FilterPoint.TASK_DATA_OUT] = FilterChain([filt])
    server[FilterPoint.TASK_RESULT_IN] = FilterChain([DequantizeFilter(device)])
    client = no_filters()
    client[FilterPoint.TASK_DATA_IN] = FilterChain([DequantizeFilter(device)])
    client[FilterPoint.TASK_RESULT_OUT] = FilterChain([filt])
    return server, client, filt


def run(policy_name: str, device: Any) -> FLSimulator:
    device = resolve_device(device)
    w_true = np.sin(np.linspace(0, 8 * np.pi, DIM)).astype(np.float32)
    network = heterogeneous_network(NAMES, seed=0, compute_base_s=0.3, compute_spread=5.0)
    availability = random_availability(NAMES, mean_online_s=90.0, mean_offline_s=30.0,
                                       horizon_s=600.0, seed=0)
    server_f, client_f, filt = build_filters(network, device)
    if policy_name == "fedasync":
        policy = FedAsyncPolicy(total_tasks=ROUNDS * NUM_CLIENTS, mixing_rate=0.6,
                                device=device)
    else:
        policy = TieredPolicy(FedAvgAggregator(device), num_rounds=ROUNDS * 2,
                              num_tiers=3, network=network, seed=1)
    losses: list = []
    sim = FLSimulator(
        [make_client(n, i, w_true, losses) for i, n in enumerate(NAMES)],
        FedAvgAggregator(device),
        SimulationConfig(num_rounds=ROUNDS, transmission="container"),
        server_filters=server_f,
        client_filters=client_f,
        runtime=RuntimeConfig(seed=0, max_concurrency=NUM_CLIENTS,
                              dropout_prob=0.05, max_retries=2),
        policy=policy,
        network=network,
        availability=availability,
        device=device,
    )
    sim.run({"w": torch.zeros(DIM, dtype=torch.float32, device=device)})
    ordered = [loss for _, loss in sorted(losses)]
    k = max(1, len(ordered) // 4)
    first, last = np.mean(ordered[:k]), np.mean(ordered[-k:])
    s = sim.scheduler.stats
    print(f"\n== {policy_name} ==")
    print(f"  simulated makespan: {s.sim_time_s:7.2f} s "
          f"| model updates: {s.model_updates} "
          f"| client loss {first:.3f} -> {last:.3f}")
    print(f"  dispatches: {s.dispatches} | deferrals: {s.deferrals} "
          f"| interruptions: {s.interruptions} | dropouts: {s.dropouts} "
          f"| wire: {sim.stats.bytes_sent / 1e6:.2f} MB")
    if policy_name == "tiered":
        print(f"  tiers: {policy.tiers}")
        print(f"  rounds served by tier: {policy.selected_tiers}")
    print("  link -> wire precision (adaptive):")
    for n in NAMES:
        fmt = filt.last_fmt_by_client.get(n, "-")
        print(f"    {n}: {network.link(n).name:9s} -> {fmt}")
    return sim


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the message plane (default: cuda; cpu on request)")
    device = resolve_device(ap.parse_args(argv).device)
    run("fedasync", device)
    run("tiered", device)


if __name__ == "__main__":
    main()
