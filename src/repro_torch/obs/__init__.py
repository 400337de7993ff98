"""Observability plane: span tracing + metrics registry (copied from
``src/repro/obs``; the tracer can also synchronise a device at span
edges)."""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, activate, validate_chrome_trace

__all__ = ["MetricsRegistry", "Tracer", "activate", "validate_chrome_trace"]
