"""Async federation demo on the PyTorch port: stragglers, dropouts, and
buffered aggregation.

Eight clients on heterogeneous links (fiber down to 3G) train a toy
least-squares model. The same task budget runs twice through the
event-driven runtime: once with the round-barrier SyncPolicy (every
round waits for the 3G straggler) and once with FedBuff buffered async
aggregation (fast clients keep contributing). Both runs use int8
message quantization over the real streaming transport and inject
seeded client dropouts; timings are simulated seconds derived from the
actual wire bytes.

The message plane (blockwise8 quantize and dequantize, the aggregation)
runs on ``--device``: the card by default, where the quantize filters
launch the hand-written blockwise8 kernels. The toy clients train in
numpy on the host, as ``examples/async_federation.py``'s do, so both
print the same bytes.

    PYTHONPATH=src python examples/torch/async_federation.py
    PYTHONPATH=src python examples/torch/async_federation.py --device cpu
"""
import argparse
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.filters import two_way_quantization
from repro_torch.fl import FedAvgAggregator, FLSimulator, SimulationConfig, TrainExecutor
from repro_torch.runtime import EventKind, FedBuffPolicy, RuntimeConfig, heterogeneous_network
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_numpy

NUM_CLIENTS, ROUNDS, DIM = 8, 5, 512


def make_client(name: str, seed: int, w_true: np.ndarray) -> TrainExecutor:
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((1024, DIM)).astype(np.float32)
    y = X @ w_true

    def train_fn(params, rnd):
        w = as_numpy(params["w"]).astype(np.float32)     # a copy
        for _ in range(2):
            w -= 0.8 * (X.T @ (X @ w - y)) / len(y)
        return {"w": w}, len(y), {"loss": float(np.mean((X @ w - y) ** 2))}

    return TrainExecutor(name, train_fn)


def run(policy_name: str, device: Any) -> FLSimulator:
    device = resolve_device(device)
    names = [f"site-{i}" for i in range(NUM_CLIENTS)]
    w_true = np.sin(np.linspace(0, 8 * np.pi, DIM)).astype(np.float32)
    filters = two_way_quantization("blockwise8", device=device)
    policy = (
        FedBuffPolicy(total_tasks=ROUNDS * NUM_CLIENTS, buffer_size=4, device=device)
        if policy_name == "fedbuff"
        else None  # default: SyncPolicy, bitwise-equal to ScatterAndGather
    )
    sim = FLSimulator(
        [make_client(n, i, w_true) for i, n in enumerate(names)],
        FedAvgAggregator(device),
        SimulationConfig(num_rounds=ROUNDS, transmission="container"),
        server_filters=filters,
        client_filters=filters,
        runtime=RuntimeConfig(seed=0, max_concurrency=NUM_CLIENTS,
                              dropout_prob=0.1, max_retries=2),
        policy=policy,
        network=heterogeneous_network(names, seed=0, compute_base_s=0.3, compute_spread=5.0),
        device=device,
    )
    final = sim.run({"w": torch.zeros(DIM, dtype=torch.float32, device=device)})
    err = float(np.max(np.abs(as_numpy(final["w"]) - w_true)))
    s = sim.scheduler.stats
    print(f"\n== {policy_name} ==")
    print(f"  simulated makespan: {s.sim_time_s:7.2f} s "
          f"| model updates: {s.model_updates} | max |w - w*|: {err:.3f}")
    print(f"  dispatches: {s.dispatches} | dropouts: {s.dropouts} "
          f"| retries: {s.retries} | wire: {sim.stats.bytes_sent / 1e6:.2f} MB")
    completions = [e for e in sim.scheduler.timeline if e.kind is EventKind.COMPLETION]
    first = {e.client: e.time for e in reversed(completions)}
    slowest = max(first, key=first.get)
    print(f"  straggler: {slowest} (first completion at t={first[slowest]:.2f}s)")
    return sim


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the message plane (default: cuda; cpu on request)")
    device = resolve_device(ap.parse_args(argv).device)
    run("sync", device)
    run("fedbuff", device)


if __name__ == "__main__":
    main()
