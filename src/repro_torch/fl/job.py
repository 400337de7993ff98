"""Declarative FL job system: one dict describes the whole federation —
model, clients, data partitioning, the wire stack of each hop,
transmission, aggregation — and the runner builds and executes it.

Mirror of ``src/repro/fl/job.py``::

    spec = {"arch": "llama3.2-1b", "smoke": False, "rounds": 1, "clients": 2,
            "local_steps": 2, "batch": 4, "seq": 32, "partition": "iid",
            "pipeline": {"task_data_out": ["quantize:blockwise8"],
                         "task_result_out": ["quantize:blockwise8", "crc32"]},
            "aggregator": "quantized-fedavg", "server_streaming_agg": True,
            "transmission": "container", "driver": "loopback", "chunk_mb": 1,
            "seed": 0}
    result = run_job(spec)                  # on CUDA
    result = run_job(spec, device="cpu")    # plain PyTorch versions

or from the command line, printing a JSON summary without the weights::

    python -m repro_torch.fl.job SPEC.json [--trace OUT.json] [--device cpu]

The older ``"quantization"`` / ``"dp_sigma"`` keys build the legacy
Filter chains (the paper's two-way scheme, optionally with error
feedback, DP noise or link-adaptive precision), adapted through the
whole-message shim; they are mutually exclusive with ``"pipeline"``. With
``{"fmt": "adaptive"}`` (or an ``"adaptive"`` pipeline stage) each
client's format is reported in ``result["adaptive_fmts"]``; with a
runtime network, each client's precision tracks its simulated link.

The ``"runtime"`` block selects the async scenario engine
(:mod:`repro_torch.runtime`): a registered policy (``sync``, ``fedbuff``,
``fedasync``, ``tiered``), ``max_concurrency``, seeded dropouts, a
``network`` and an ``availability`` trace. The result then carries
``sim_time_s``, ``runtime_stats`` and ``policy``.

Entry points run on ``cuda`` unless the caller passes ``device``; with no
CUDA device they raise. On CUDA the job turns TF32 off for matmuls and
cuDNN, so training runs in full fp32 like the reference.

Local training mirrors the reference's ``_train_executor``: the spec's
model built by family (``models.create_model``; without the reference's
per-block remat, which changes memory only), round-keyed batches
from the same numpy generators (tokens and labels only, so an enc-dec
spec raises ``KeyError: 'frames'`` in its first local step, as the
reference's does), AdamW re-initialised every round, ``local_steps``
steps of PyTorch autograd. Initial weights come
from a seeded ``torch.Generator`` with the reference's initialiser
scales, or from ``weights=`` — e.g. the reference's own weights carried
across with :func:`repro_torch.utils.trees.from_reference_state` — so both
packages can start from the same numbers.

The live plane's keys (``quorum``, ``straggler_grace_s``,
``max_reconnects``, ``checkpoint``, ``chaos``) are read by
:mod:`repro_torch.launch.federation`; ``run_job`` ignores them, as the
reference's does. ``kernel_backend`` raises: the port dispatches by
device.

One key is the port's own: ``"num_layers"`` builds the spec's model at
that depth (its widths unchanged) — a full-width model cut to fit a run
on one card. Left out (or ``None``), the model has its published depth,
as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.filters import (
    AdaptiveQuantizeFilter,
    DequantizeFilter,
    DPGaussianNoiseFilter,
    ErrorFeedbackQuantizeFilter,
    FilterChain,
    FilterPoint,
    QuantizeFilter,
    no_filters,
)
from repro_torch.core.pipeline import AdaptiveQuantizeStage, build_pipeline
from repro_torch.data import dirichlet_partition, iid_partition
from repro_torch.fl.aggregator import aggregator_consumes_wire, build_aggregator
from repro_torch.fl.executor import TrainExecutor
from repro_torch.fl.simulator import FLSimulator, SimulationConfig
from repro_torch.models import create_model
from repro_torch.obs import Tracer
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.device import disable_tf32, resolve_device
from repro_torch.utils.trees import (
    check_state,
    flatten_state_dict,
    from_reference_state,
    tree_leaves,
    unflatten_state_dict,
)

DEFAULTS: dict[str, Any] = {
    "smoke": True,
    "rounds": 5,
    "local_steps": 4,
    "batch": 8,
    "seq": 64,
    "lr": 3e-3,
    "clients": 3,
    "partition": "iid",
    "alpha": 0.5,
    "quantization": None,
    "dp_sigma": 0.0,
    "pipeline": None,
    "transmission": "container",
    "driver": "loopback",
    "chunk_mb": 1,
    "server_quantized_aggregation": False,
    "server_streaming_agg": False,
    "aggregator": None,
    "runtime": None,
    "kernel_backend": None,
    "trace": None,
    "quorum": None,
    "straggler_grace_s": 30.0,
    "max_reconnects": 5,
    "checkpoint": None,
    "chaos": None,
    "seed": 0,
}

#: spec keys the port refuses, with the reason
_NOT_PORTED_KEYS = {
    "kernel_backend": "backend selection; the port dispatches by device",
}


def normalize_spec(spec: dict[str, Any]) -> dict[str, Any]:
    """The canonical spec every constructor here consumes: ``DEFAULTS`` applied;
    raises ``NotImplementedError`` for keys whose features are not ported."""
    out = {**DEFAULTS, **spec}
    for key, what in _NOT_PORTED_KEYS.items():
        if out.get(key):
            raise NotImplementedError(f'spec key "{key}" needs {what}, not ported yet')
    return out


_PIPELINE_DIRECTIONS = {
    "task_data": "task_data",
    "task_data_out": "task_data",
    "task_result": "task_result",
    "task_result_out": "task_result",
}


def aggregator_spec(spec: dict[str, Any]) -> Any:
    """Resolve the spec's aggregator selection exactly as the reference does."""
    spec = normalize_spec(spec)
    agg = spec.get("aggregator")
    if agg is None:
        agg = (
            "quantized-fedavg"
            if spec.get("server_quantized_aggregation")
            and (spec.get("quantization") or spec.get("pipeline"))
            else "fedavg"
        )
    return agg


def _adaptive_filter(q: dict[str, Any], device: Any,
                     network: Optional[Any]) -> AdaptiveQuantizeFilter:
    f = AdaptiveQuantizeFilter(
        bandwidth_bps=float(q.get("bandwidth_mbps", 80.0)) * 1e6,  # wifi-class fallback
        budget_s=float(q.get("budget_s", 1.0)),
        min_params=int(q.get("min_params", 0)),
        device=device,
    )
    if network is not None:
        f.bind_network(network)
    return f


def _build_pipelines(spec: dict[str, Any], device: Any, network: Optional[Any] = None
                     ) -> tuple[dict[str, Any], list[AdaptiveQuantizeStage]]:
    """The ``"pipeline"`` spec block as simulator pipelines on ``device``,
    and the adaptive stages found (reported in ``result["adaptive_fmts"]``;
    bound to the runtime's ``network`` when there is one). Aggregators
    that fold wire-form payloads get an uplink left undecoded."""
    p = spec["pipeline"] or {}
    if spec.get("quantization") or spec.get("dp_sigma"):
        raise ValueError(
            '"pipeline" replaces the legacy "quantization"/"dp_sigma" keys; '
            'declare those transforms as stages (e.g. "quantize:nf4", '
            '{"stage": "dp-noise", "sigma": 0.01})'
        )
    unknown = set(p) - set(_PIPELINE_DIRECTIONS)
    if unknown:
        raise ValueError(
            f"unknown pipeline directions {sorted(unknown)}; "
            f"valid: {sorted(_PIPELINE_DIRECTIONS)}"
        )
    specs: dict[str, list[Any]] = {"task_data": [], "task_result": []}
    for key, stages in p.items():
        specs[_PIPELINE_DIRECTIONS[key]] += list(stages or [])
    keep_wire = bool(spec.get("server_quantized_aggregation")) or \
        aggregator_consumes_wire(aggregator_spec(spec))
    pipelines = {
        "task_data": build_pipeline(specs["task_data"], device=device),
        "task_result": build_pipeline(specs["task_result"], decode_values=not keep_wire,
                                      device=device),
    }
    adaptive: list[AdaptiveQuantizeStage] = []
    for pl in pipelines.values():
        for stage in pl.stages:
            if isinstance(stage, AdaptiveQuantizeStage):
                if keep_wire:
                    raise ValueError(
                        "server_quantized_aggregation does not compose with the "
                        "adaptive stage: clients may ship mixed formats"
                    )
                if network is not None:
                    stage.bind_network(network)
                adaptive.append(stage)
    return pipelines, adaptive


def build_pipelines_from_spec(spec: dict[str, Any], device: Any = None) -> dict[str, Any]:
    """Wire pipelines for a job spec, bound to ``device``. Specs without
    a ``"pipeline"`` block get identity pipelines; the legacy
    ``"quantization"`` / ``"dp_sigma"`` keys build whole-message Filter
    chains with no pipeline form and are rejected here."""
    spec = normalize_spec(spec)
    if spec.get("pipeline"):
        return _build_pipelines(spec, device)[0]
    if spec.get("quantization") or spec.get("dp_sigma"):
        raise ValueError(
            'the legacy "quantization"/"dp_sigma" keys build whole-message '
            'Filter chains with no streaming-pipeline form; declare them as '
            '"pipeline" stages (e.g. "quantize:nf4", '
            '{"stage": "dp-noise", "sigma": 0.01})'
        )
    keep_wire = bool(spec.get("server_quantized_aggregation")) or \
        aggregator_consumes_wire(aggregator_spec(spec))
    return {
        "task_data": build_pipeline([], device=device),
        "task_result": build_pipeline([], decode_values=not keep_wire, device=device),
    }


def _build_filters(spec: dict[str, Any], device: Any, network: Optional[Any] = None):
    """Two-way scheme (+optional EF / DP / link-adaptive) from the job
    spec, as the reference builds it: one filter instance per point,
    shared by every client — one DP generator drawn in client order, one
    error-feedback residual per tensor name across the clients of a hop."""
    server = no_filters()
    client = no_filters()
    adaptive: list[AdaptiveQuantizeFilter] = []
    q = spec.get("quantization")
    if q:
        fmt = q["fmt"]
        if fmt == "adaptive":
            if q.get("error_feedback"):
                raise ValueError("error_feedback does not compose with adaptive precision")
            if spec.get("server_quantized_aggregation"):
                # per-client formats can differ (that's the point), and the
                # fused aggregator needs one uniform wire format
                raise ValueError(
                    "server_quantized_aggregation does not compose with adaptive "
                    "precision: clients may ship mixed formats"
                )

            def mk():
                adaptive.append(_adaptive_filter(q, device, network))
                return adaptive[-1]
        elif q.get("error_feedback"):
            def mk():
                return ErrorFeedbackQuantizeFilter(fmt, device=device)
        else:
            def mk():
                return QuantizeFilter(fmt, device=device)
        server[FilterPoint.TASK_DATA_OUT] = FilterChain([mk()])
        client[FilterPoint.TASK_DATA_IN] = FilterChain([DequantizeFilter(device)])
        out_chain: list[Any] = []
        if spec.get("dp_sigma"):
            out_chain.append(DPGaussianNoiseFilter(spec["dp_sigma"], seed=spec["seed"]))
        out_chain.append(mk())
        client[FilterPoint.TASK_RESULT_OUT] = FilterChain(out_chain)
        if not spec.get("server_quantized_aggregation"):
            server[FilterPoint.TASK_RESULT_IN] = FilterChain([DequantizeFilter(device)])
    elif spec.get("dp_sigma"):
        client[FilterPoint.TASK_RESULT_OUT] = FilterChain(
            [DPGaussianNoiseFilter(spec["dp_sigma"], seed=spec["seed"])]
        )
    return server, client, adaptive


def _build_runtime(spec: dict[str, Any], aggregator: Any, client_names: list[str],
                   device: torch.device) -> dict[str, Any]:
    """The ``"runtime"`` spec block as FLSimulator kwargs (empty without one);
    the barrier-free policies keep their weights on ``device``."""
    r = spec.get("runtime")
    if not r:
        return {}
    # imported here: repro_torch.runtime imports repro_torch.fl.controller
    from repro_torch.runtime import (
        RuntimeConfig,
        availability_from_spec,
        network_from_spec,
        polynomial_staleness,
    )
    from repro_torch.runtime.async_agg import build_policy

    r = dict(r)
    policy_name = r.get("policy", "sync")
    if policy_name in ("fedbuff", "fedasync") and spec.get("server_quantized_aggregation"):
        # these policies aggregate deltas/weights directly (not through the
        # aggregator) and skip QuantizedTensor payload items — quantized
        # server ingress would silently aggregate nothing
        raise ValueError(
            f"server_quantized_aggregation is not supported with policy "
            f"{policy_name!r}; it requires the aggregator path (sync/tiered)"
        )
    seed = int(r.get("seed", spec["seed"]))
    network = network_from_spec(r["network"], client_names) if r.get("network") else None
    availability = (
        availability_from_spec(r["availability"], client_names)
        if r.get("availability") else None
    )
    config = RuntimeConfig(
        seed=seed,
        max_concurrency=int(r.get("max_concurrency", 8)),
        dropout_prob=float(r.get("dropout_prob", 0.0)),
        max_retries=int(r.get("max_retries", 2)),
    )
    policy = build_policy(policy_name, r, {
        "aggregator": aggregator,
        "rounds": spec["rounds"],
        "client_names": client_names,
        "network": network,
        "seed": seed,
        "total_tasks": int(r.get("total_tasks", spec["rounds"] * len(client_names))),
        "staleness": polynomial_staleness(float(r.get("staleness_alpha", 0.5))),
        "device": device,
    })
    return {
        "runtime": config,
        "policy": policy,
        "network": network,
        "availability": availability,
    }


def _client_datasets(spec: dict[str, Any], cfg: Any) -> list[Any]:
    """Deterministic per-client datasets (the reference's numpy generators)."""
    if spec["partition"] == "dirichlet":
        return dirichlet_partition(
            cfg.vocab_size, spec["seq"], spec["clients"],
            alpha=spec["alpha"], seed=spec["seed"],
        )
    return iid_partition(cfg.vocab_size, spec["seq"], spec["clients"], seed=spec["seed"])


def _model_config(spec: dict[str, Any]) -> Any:
    """The spec's model config with remat off. Remat changes memory only,
    and a round's local step peaks on AdamW's state (weights, gradients
    and two moments) at a job's local batch, so recomputing each block
    would add a forward and save nothing."""
    cfg = get_smoke_config(spec["arch"]) if spec["smoke"] else get_config(spec["arch"])
    cfg = cfg.with_overrides(remat=False)
    layers = spec.get("num_layers")
    return cfg if layers is None else cfg.with_overrides(num_layers=int(layers))


def _train_executor(
    name: str, data: Any, spec: dict[str, Any], model: Any, device: torch.device,
    history: Optional[list[float]] = None,
) -> TrainExecutor:
    def train_fn(flat_params, rnd):
        # client.train holds train.setup, then train.batch / .forward /
        # .backward / .optimizer for each step (arg ``step``), then
        # train.readback, where the host waits for the card
        with obs_trace.span("client.train", "fl", client=name, round=rnd):
            with obs_trace.span("train.setup", "fl"):
                # decoded downlink tensors become this client's parameters
                # and are updated in place; numpy inputs are copied first
                flat = {
                    k: (v if isinstance(v, torch.Tensor) else torch.tensor(v))
                    .to(device=device, dtype=torch.float32).requires_grad_(True)
                    for k, v in flat_params.items()
                }
                p = unflatten_state_dict(flat)
                leaves = tree_leaves(p)
                opt = adamw_init(p)
            loss = None
            # round-keyed sampling: the update is a pure function of
            # (params, rnd), as in the reference
            for step in range(spec["local_steps"]):
                with obs_trace.span("train.batch", "fl", step=step):
                    batch = {
                        k: torch.as_tensor(v, device=device).long()
                        for k, v in data.sample_at(
                            spec["batch"], rnd * spec["local_steps"] + step
                        ).items()
                    }
                with obs_trace.span("train.forward", "fl", step=step):
                    loss, _ = model.loss(p, batch)
                with obs_trace.span("train.backward", "fl", step=step):
                    grads = torch.autograd.grad(loss, leaves)
                with obs_trace.span("train.optimizer", "fl", step=step):
                    _, opt, _ = adamw_update(p, list(grads), opt, spec["lr"])
                del grads
            with obs_trace.span("train.readback", "fl"):
                loss_f = float(loss.detach())
        if history is not None:
            history.append(loss_f)
        out = {k: t.detach() for k, t in flatten_state_dict(p).items()}
        return out, spec["batch"] * spec["local_steps"], {"loss": loss_f}

    return TrainExecutor(name, train_fn)


def build_client_executor(
    spec: dict[str, Any], index: int, history: Optional[list[float]] = None,
    device: Any = None,
) -> TrainExecutor:
    """The executor for client ``index`` exactly as the simulator builds it."""
    spec = normalize_spec(spec)
    device = resolve_device(device)
    cfg = _model_config(spec)
    datasets = _client_datasets(spec, cfg)
    if not 0 <= index < len(datasets):
        raise ValueError(f"client index {index} out of range for {len(datasets)} clients")
    return _train_executor(f"site-{index}", datasets[index], spec, create_model(cfg),
                           device, history)


def initial_weights(spec: dict[str, Any], device: Any = None) -> dict[str, torch.Tensor]:
    """Round-0 global weights for a spec (flat state dict on ``device``),
    from a ``torch.Generator`` seeded with ``spec["seed"]``."""
    spec = normalize_spec(spec)
    device = resolve_device(device)
    model = create_model(_model_config(spec))
    return flatten_state_dict(model.init(spec["seed"], device))


@dataclasses.dataclass
class Job:
    """A fully-constructed federation, ready to run (or inspect)."""

    spec: dict[str, Any]
    sim: FLSimulator
    init_weights: dict[str, Any]
    history: list[float]
    # legacy AdaptiveQuantizeFilter instances or adaptive pipeline stages —
    # anything exposing last_fmt_by_client
    adaptive_filters: list[Any]

    def run(self) -> dict[str, Any]:
        final = self.sim.run(self.init_weights)
        out = {
            "final_weights": final,
            "history": self.history,
            "messages": self.sim.stats.messages,
            "wire_bytes": self.sim.stats.bytes_sent,
            "round_log": self.sim.round_log,
            "telemetry": self.sim.telemetry(),
        }
        if self.sim.scheduler is not None:
            out["sim_time_s"] = self.sim.sim_time_s
            out["runtime_stats"] = self.sim.scheduler.stats.as_dict()
            out["policy"] = self.sim.scheduler.policy.name
        if self.sim.tracer is not None and isinstance(self.spec.get("trace"), str):
            out["trace"] = self.sim.tracer.write(self.spec["trace"])
        if self.adaptive_filters:
            fmts: dict[str, str] = {}
            for f in self.adaptive_filters:
                fmts.update(f.last_fmt_by_client)
            out["adaptive_fmts"] = fmts
        return out


def build_job(spec: dict[str, Any], *, device: Any = None,
              weights: Optional[dict[str, Any]] = None) -> Job:
    """Construct the federation a spec describes, without running it.

    ``weights`` replaces the seeded init: a flat dict of tensors, or of
    numpy arrays (the reference's ``initial_weights``), checked against
    the model's names and shapes. With tracing on (``"trace"`` truthy)
    the simulator records spans in host time, without synchronising
    the device, so the trace shows the run as it runs untraced; the
    device's time comes from a profiler laid beside it through the
    trace's ``otherData["clock"]`` (:func:`repro_torch.obs.trace.profiler_ns`).
    """
    spec = normalize_spec(spec)
    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    cfg = _model_config(spec)
    model = create_model(cfg)
    datasets = _client_datasets(spec, cfg)
    history: list[float] = []
    executors = [
        _train_executor(f"site-{i}", d, spec, model, device, history)
        for i, d in enumerate(datasets)
    ]
    expect = {name: (shape, cfg.param_dtype)
              for name, shape in model.param_shapes().items()}
    if weights is None:
        init = flatten_state_dict(model.init(spec["seed"], device))
    elif all(isinstance(v, torch.Tensor) for v in weights.values()):
        check_state(weights, expect)
        init = {name: weights[name].to(device) for name in sorted(weights)}
    else:
        init = from_reference_state(weights, device, expect)
    tracer = Tracer() if spec.get("trace") else None
    agg = build_aggregator(aggregator_spec(spec), device=device)
    runtime_kwargs = _build_runtime(spec, agg, [ex.name for ex in executors], device)
    network = runtime_kwargs.get("network")
    if spec.get("pipeline"):
        pipelines, adaptive = _build_pipelines(spec, device, network)
        wire_kwargs: dict[str, Any] = {"pipelines": pipelines}
    else:
        server_filters, client_filters, adaptive = _build_filters(spec, device, network)
        wire_kwargs = {"server_filters": server_filters, "client_filters": client_filters}
    sim = FLSimulator(
        executors,
        agg,
        SimulationConfig(
            num_rounds=spec["rounds"],
            transmission=spec["transmission"],
            chunk_size=int(spec["chunk_mb"] * (1 << 20)),
            driver=spec["driver"],
        ),
        server_streaming_agg=bool(spec.get("server_streaming_agg")),
        trace=tracer,
        device=device,
        **wire_kwargs,
        **runtime_kwargs,
    )
    return Job(spec, sim, init, history, adaptive)


def run_job(spec: dict[str, Any], *, device: Any = None,
            weights: Optional[dict[str, Any]] = None) -> dict[str, Any]:
    return build_job(spec, device=device, weights=weights).run()


def run_job_file(path: str, *, device: Any = None) -> dict[str, Any]:
    with open(path) as fh:
        return run_job(json.load(fh), device=device)


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m repro_torch.fl.job SPEC.json [--trace OUT] [--device cpu]``
    — run a declarative job on the card (or on ``--device``) and print a
    JSON summary (weights omitted). ``--trace`` turns on the span tracer
    and writes the run's Chrome trace-event file: host time, with no
    device syncs; a profiler's device trace lines up with it through the
    file's ``otherData["clock"]`` pairs."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fl.job",
        description="Run a declarative FL job spec.",
    )
    ap.add_argument("spec", help="path to a JSON job spec")
    ap.add_argument("--trace", metavar="OUT_JSON", default=None,
                    help="record a span trace and write Chrome trace-event "
                         "JSON here (open in Perfetto)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    args = ap.parse_args(argv)
    with open(args.spec) as fh:
        spec = json.load(fh)
    if args.trace:
        spec["trace"] = args.trace
    result = run_job(spec, device=args.device)
    result.pop("final_weights", None)
    print(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

