"""Quickstart on the PyTorch port: 3-client federated training with
message quantization and container streaming, end to end through the
real stack — Controller, Executors, a quantize+zlib+crc32 wire pipeline,
SFM chunked wire.

The model (the llama3.2-1b smoke config at vocab 256, d_model 128, d_ff
256), its local AdamW steps and the wire pipelines run on ``--device``:
the card by default, where blockwise8 quantize and dequantize launch the
hand-written kernels. Weights are drawn through a ``torch.Generator``
(seed 0); the clients' data is the reference's seeded Dirichlet
partition.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse
from typing import Any, Optional

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.pipeline import build_pipeline
from repro_torch.data import dirichlet_partition
from repro_torch.fl import FedAvgAggregator, FLSimulator, SimulationConfig, TrainExecutor
from repro_torch.models import create_model
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.device import disable_tf32, resolve_device
from repro_torch.utils.trees import (
    as_tensor,
    flatten_state_dict,
    tree_leaves,
    unflatten_state_dict,
)

ROUNDS, LOCAL_STEPS, BATCH, SEQ = 5, 4, 8, 64
LR = 3e-3
# the paper's §II-C two-way scheme as a wire-pipeline stack: quantize
# + compress + checksum run per item inside the container streamer
STACK = ["quantize:blockwise8", "zlib", "crc32"]


def make_config():
    return get_smoke_config("llama3.2-1b").with_overrides(vocab_size=256, d_model=128, d_ff=256)


def make_client(name: str, data: Any, model: Any, device: torch.device) -> TrainExecutor:
    def train_fn(flat_params, rnd):
        # the decoded downlink becomes this client's parameters, updated in place
        params = unflatten_state_dict({
            k: as_tensor(v, device).to(torch.float32).clone().requires_grad_(True)
            for k, v in flat_params.items()})
        leaves = tree_leaves(params)
        opt = adamw_init(params)
        loss = None
        for _ in range(LOCAL_STEPS):
            batch = {k: torch.as_tensor(v, device=device).long()
                     for k, v in data.sample(BATCH).items()}
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            _, opt, _ = adamw_update(params, list(grads), opt, LR)
        loss_f = float(loss.detach())
        print(f"    {name}: round {rnd} local loss {loss_f:.4f}")
        out = {k: t.detach() for k, t in flatten_state_dict(params).items()}
        return out, BATCH * LOCAL_STEPS, {"loss": loss_f}

    return TrainExecutor(name, train_fn)


def run(device: Any, init: Optional[dict[str, Any]] = None) -> tuple[FLSimulator, dict]:
    """The federation from ``init`` (a flat state dict; default: the
    model's seeded init on ``device``); returns the simulator and the
    final global weights."""
    device = resolve_device(device)
    disable_tf32()
    cfg = make_config()
    model = create_model(cfg)
    datasets = dirichlet_partition(cfg.vocab_size, SEQ, num_clients=3, alpha=0.5)
    sim = FLSimulator(
        [make_client(f"site-{i}", ds, model, device) for i, ds in enumerate(datasets)],
        FedAvgAggregator(device),
        SimulationConfig(num_rounds=ROUNDS, transmission="container"),
        pipelines={hop: build_pipeline(STACK, device=device)
                   for hop in ("task_data", "task_result")},
        device=device,
    )
    if init is None:
        init = flatten_state_dict(model.init(0, device))
    final = sim.run(init)
    print(f"\nrounds: {ROUNDS} | messages: {sim.stats.messages} "
          f"| wire bytes: {sim.stats.bytes_sent/1e6:.1f} MB (int8+zlib wire)")
    print(f"final global weights: {len(final)} tensors")
    return sim, final


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the wire (default: cuda; cpu on request)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
