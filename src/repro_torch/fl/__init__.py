"""Federated-learning plane: aggregators, controller, executors, simulator,
job system. Re-exports what ``repro.fl`` does."""
from repro_torch.fl.aggregator import (
    Aggregator,
    CollectingSink,
    FedAvgAggregator,
    LoRAFedAvgAggregator,
    QuantizedFedAvgAggregator,
    aggregator_consumes_wire,
    build_aggregator,
    register_aggregator,
    registered_aggregators,
)
from repro_torch.fl.controller import ScatterAndGather, make_task
from repro_torch.fl.executor import Executor, TrainExecutor
from repro_torch.fl.simulator import FLSimulator, SimulationConfig, TrafficStats

__all__ = [
    "Aggregator",
    "CollectingSink",
    "FedAvgAggregator",
    "LoRAFedAvgAggregator",
    "QuantizedFedAvgAggregator",
    "aggregator_consumes_wire",
    "build_aggregator",
    "register_aggregator",
    "registered_aggregators",
    "ScatterAndGather",
    "make_task",
    "Executor",
    "TrainExecutor",
    "FLSimulator",
    "SimulationConfig",
    "TrafficStats",
]
