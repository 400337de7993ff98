"""Event-driven async federated runtime (mirror of ``src/repro/runtime``).

* :mod:`repro_torch.runtime.events` — deterministic simulated-clock event
  loop and client availability traces.
* :mod:`repro_torch.runtime.network` — per-client link/compute models that
  turn actual wire bytes into simulated time.
* :mod:`repro_torch.runtime.async_agg` — aggregation policies: round-barrier
  :class:`SyncPolicy`, staleness-weighted :class:`FedBuffPolicy`,
  per-update :class:`FedAsyncPolicy` and latency-tiered
  :class:`TieredPolicy`, with their weights on a torch device.
* :mod:`repro_torch.runtime.scheduler` — the orchestrator: concurrent
  real-transport execution on a thread pool, dropouts, availability
  deferral and interrupts, the timeline.
"""
from repro_torch.runtime.async_agg import (
    AggregationPolicy,
    Dispatch,
    FedAsyncPolicy,
    FedBuffPolicy,
    SyncPolicy,
    TieredPolicy,
    polynomial_staleness,
)
from repro_torch.runtime.events import (
    AvailabilityTrace,
    Event,
    EventKind,
    EventLoop,
    availability_from_spec,
    periodic_availability,
    random_availability,
)
from repro_torch.runtime.network import (
    PROFILES,
    ComputeProfile,
    LinkProfile,
    NetworkModel,
    heterogeneous_network,
    network_from_spec,
)
from repro_torch.runtime.scheduler import AsyncFLScheduler, RuntimeConfig, RuntimeStats

__all__ = [
    "AggregationPolicy",
    "Dispatch",
    "FedAsyncPolicy",
    "FedBuffPolicy",
    "SyncPolicy",
    "TieredPolicy",
    "polynomial_staleness",
    "AvailabilityTrace",
    "Event",
    "EventKind",
    "EventLoop",
    "availability_from_spec",
    "periodic_availability",
    "random_availability",
    "PROFILES",
    "ComputeProfile",
    "LinkProfile",
    "NetworkModel",
    "heterogeneous_network",
    "network_from_spec",
    "AsyncFLScheduler",
    "RuntimeConfig",
    "RuntimeStats",
]
