"""Port parity, the async runtime: ``repro_torch.runtime`` against
``repro.runtime`` on the same seeds and the same numpy inputs.

* The event loop pops the same (time, seq) order; availability traces
  (windows, periodic, random, from a spec or a file) answer every query
  the same.
* Network models give the same link and compute seconds, jitter draws
  included, for the same clients and bytes.
* Every policy (Sync, FedBuff, FedAsync, Tiered), batch and streaming,
  over the simulator with fixed updates (each client returns the
  parameters it received plus a seeded numpy step): the timeline, the
  staleness list, ``RuntimeStats``, the traffic and the final weights
  are bitwise the reference's. FedBuff's and FedAsync's weights are
  float32 tensors on the policy's device here and numpy there, with the
  same roundings in the same order.
* Seeded dropouts with retries, and an availability trace with
  deferrals and interrupts, give the same timeline and weights.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import runtime as ref_rt  # noqa: E402
from repro.fl import FLSimulator as RefSimulator  # noqa: E402
from repro.fl import SimulationConfig as RefConfig  # noqa: E402
from repro.fl import TrainExecutor as RefExecutor  # noqa: E402
from repro.fl.aggregator import FedAvgAggregator as RefFedAvg  # noqa: E402
from repro.runtime import async_agg as ref_agg  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.fl.aggregator import FedAvgAggregator  # noqa: E402
from repro_torch.fl.executor import TrainExecutor  # noqa: E402
from repro_torch.fl.simulator import FLSimulator, SimulationConfig  # noqa: E402
from repro_torch.runtime import async_agg  # noqa: E402

CLIENTS = [f"site-{i}" for i in range(4)]


def _timeline(sim):
    return [(e.kind.value, e.client, e.time, e.seq, e.data.get("version"),
             e.data.get("attempt")) for e in sim.scheduler.timeline]


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _init():
    rng = np.random.default_rng(0)
    return {"b": rng.standard_normal((5000,)).astype(np.float32),
            "w": rng.standard_normal((16, 24)).astype(np.float32),
            "step": np.arange(3, dtype=np.int32)}


def _fixed_train_fn(index):
    """params + a seeded step (numpy arithmetic in both packages), so the
    update depends on what the client received."""
    def train_fn(params, rnd):
        rng = np.random.default_rng((index, rnd))
        out = {}
        for k, v in params.items():
            a = _np(v)
            if np.issubdtype(a.dtype, np.floating):
                a = (a + rng.standard_normal(a.shape).astype(np.float32)
                     * np.float32(0.1 * (index + 1))).astype(np.float32)
            out[k] = a
        return out, 2 + 3 * index, {}
    return train_fn


NETWORK = {"kind": "hetero", "tiers": ["fiber", "lte", "3g"], "seed": 1}


def _policies(pkg, agg):
    """name -> policy factory for one package (fresh instances per run)."""
    stal = pkg.polynomial_staleness(0.5)
    dev = {} if pkg is ref_rt else {"device": "cpu"}
    return {
        "sync": lambda net: None,
        "fedbuff": lambda net: pkg.FedBuffPolicy(9, buffer_size=2, server_lr=0.7,
                                                 staleness_weight=stal, **dev),
        "fedasync": lambda net: pkg.FedAsyncPolicy(9, mixing_rate=0.6,
                                                   staleness_weight=stal, **dev),
        "tiered": lambda net: pkg.TieredPolicy(agg, 3, num_tiers=2, network=net, seed=3),
    }


def _run(pkg, policy_name, streaming, runtime_kwargs=None, network=NETWORK,
         availability=None, rounds=3):
    init = _init()
    if pkg is ref_rt:
        agg = RefFedAvg()
        execs = [RefExecutor(c, _fixed_train_fn(i)) for i, c in enumerate(CLIENTS)]
        make_sim, cfg, extra = RefSimulator, RefConfig(num_rounds=rounds), {}
        weights = init
    else:
        agg = FedAvgAggregator("cpu")
        execs = [TrainExecutor(c, _fixed_train_fn(i)) for i, c in enumerate(CLIENTS)]
        make_sim, cfg, extra = FLSimulator, SimulationConfig(num_rounds=rounds), {
            "device": "cpu", "pipelines": {}}
        weights = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    net = pkg.network_from_spec(network, CLIENTS)
    policy = _policies(pkg, agg)[policy_name](net)
    avail = pkg.availability_from_spec(availability, CLIENTS) if availability else None
    sim = make_sim(execs, agg, cfg, runtime=pkg.RuntimeConfig(**(runtime_kwargs or {})),
                   policy=policy, network=net, availability=avail,
                   server_streaming_agg=streaming, **extra)
    out = sim.run(weights)
    return sim, out


def _check_same(ref, port):
    (rsim, rout), (psim, pout) = ref, port
    assert _timeline(psim) == _timeline(rsim)
    assert psim.scheduler.stats.as_dict() == rsim.scheduler.stats.as_dict()
    assert psim.sim_time_s == rsim.sim_time_s
    assert psim.stats.as_dict() == rsim.stats.as_dict()
    rpol, ppol = rsim.scheduler.policy, psim.scheduler.policy
    assert getattr(ppol, "staleness_seen", None) == getattr(rpol, "staleness_seen", None)
    assert getattr(ppol, "selected_tiers", None) == getattr(rpol, "selected_tiers", None)
    assert list(pout) == list(rout)
    for name, want in rout.items():
        got = _np(pout[name])
        assert got.dtype == np.asarray(want).dtype and got.shape == np.asarray(want).shape
        assert got.tobytes() == np.asarray(want).tobytes(), name


@pytest.mark.parametrize("streaming", [False, True], ids=["batch", "streaming"])
@pytest.mark.parametrize("policy", ["sync", "fedbuff", "fedasync", "tiered"])
def test_policy_dispatches_and_weights_are_bitwise_the_reference(policy, streaming):
    ref = _run(ref_rt, policy, streaming)
    port = _run(rt, policy, streaming)
    _check_same(ref, port)
    assert port[0].scheduler.stats.completions > 0
    if policy in ("fedbuff", "fedasync"):
        assert isinstance(port[1]["w"], torch.Tensor) and port[1]["w"].dtype == torch.float32
        assert port[0].scheduler.policy.staleness_seen == \
            ref[0].scheduler.policy.staleness_seen and \
            max(port[0].scheduler.policy.staleness_seen) > 0


def test_dropouts_and_retries_match_the_reference():
    kw = {"seed": 4, "dropout_prob": 0.35, "max_retries": 1, "max_concurrency": 3}
    ref = _run(ref_rt, "fedbuff", True, kw)
    port = _run(rt, "fedbuff", True, kw)
    _check_same(ref, port)
    stats = port[0].scheduler.stats
    assert stats.dropouts > 0 and stats.retries > 0


def test_availability_deferrals_and_interrupts_match_the_reference():
    avail = {"kind": "random", "mean_online_s": 4.0, "mean_offline_s": 3.0,
             "horizon_s": 40.0, "seed": 2}
    network = {"default": "lte", "compute_base_s": 1.0, "compute_jitter": 0.1, "seed": 0}
    for policy in ("sync", "fedasync"):
        ref = _run(ref_rt, policy, False, {"seed": 1}, network, avail)
        port = _run(rt, policy, False, {"seed": 1}, network, avail)
        _check_same(ref, port)
        stats = port[0].scheduler.stats
        assert stats.deferrals > 0 or stats.interruptions > 0, policy


def test_event_loop_pops_in_the_reference_order():
    loops = (ref_rt.EventLoop(), rt.EventLoop())
    delays = [0.5, 0.0, 0.5, 1.25, 0.0, 0.75, 0.5]
    for loop, kinds in zip(loops, (ref_rt.EventKind, rt.EventKind)):
        for i, d in enumerate(delays):
            loop.schedule(d, list(kinds)[i % len(kinds)], f"c{i % 3}", i=i)
    got = [(e.time, e.seq, e.kind.value, e.client, e.data["i"]) for e in loops[1].drain()]
    want = [(e.time, e.seq, e.kind.value, e.client, e.data["i"]) for e in loops[0].drain()]
    assert got == want and loops[1].now == loops[0].now == 1.25
    with pytest.raises(ValueError, match="past"):
        loops[1].schedule_at(1.0, rt.EventKind.ARRIVAL)
    assert [k.value for k in rt.EventKind] == [k.value for k in ref_rt.EventKind]


@pytest.mark.parametrize("spec", [
    {"kind": "windows", "windows": {"site-0": [[0, 2], [5, "inf"]], "site-2": [[1, 3]]}},
    {"kind": "periodic", "period_s": 10, "duty_cycle": 0.4, "horizon_s": 60},
    {"kind": "random", "mean_online_s": 5, "mean_offline_s": 2, "horizon_s": 50, "seed": 3},
], ids=["windows", "periodic", "random"])
def test_availability_traces_answer_like_the_reference(spec, tmp_path):
    ref_tr = ref_rt.availability_from_spec(spec, CLIENTS)
    port_tr = rt.availability_from_spec(spec, CLIENTS)
    path = tmp_path / "trace.json"
    port_tr.to_file(str(path))
    loaded = rt.AvailabilityTrace.from_file(str(path))
    for c in CLIENTS:
        assert port_tr.windows(c) == ref_tr.windows(c) == loaded.windows(c)
        for t in np.linspace(0.0, 70.0, 141):
            t = float(t)
            assert port_tr.is_online(c, t) == ref_tr.is_online(c, t)
            assert port_tr.next_arrival(c, t) == ref_tr.next_arrival(c, t)
            assert port_tr.online_until(c, t) == ref_tr.online_until(c, t)
    assert json.loads(path.read_text())


@pytest.mark.parametrize("spec", [
    NETWORK,
    {"default": "wifi", "profiles": {"site-0": "fiber",
                                     "site-1": {"bandwidth_mbps": 5, "latency_ms": 80,
                                                "jitter": 0.2}},
     "compute": {"site-0": 0.5}, "compute_base_s": 1.5, "compute_jitter": 0.05, "seed": 7},
], ids=["hetero", "profiles"])
def test_network_models_give_the_reference_seconds(spec):
    ref_net, port_net = ref_rt.network_from_spec(spec, CLIENTS), rt.network_from_spec(spec,
                                                                                  CLIENTS)
    assert dict(rt.PROFILES) == {k: rt.LinkProfile(**vars(v))
                                 for k, v in ref_rt.PROFILES.items()}
    for rep in range(3):
        for i, c in enumerate(reversed(CLIENTS)):
            nbytes = 1000 * (7 ** (i + rep))
            assert port_net.transfer_seconds(c, nbytes) == ref_net.transfer_seconds(c, nbytes)
            assert port_net.compute_seconds(c) == ref_net.compute_seconds(c)
            assert port_net.floor_seconds(c) == ref_net.floor_seconds(c)
            assert port_net.bandwidth_bps(c) == ref_net.bandwidth_bps(c)


def test_policy_registry_matches_the_reference():
    assert async_agg.registered_policies() == ref_agg.registered_policies()
    with pytest.raises(ValueError, match="unknown runtime policy"):
        async_agg.build_policy("nope", {}, {})
    pol = async_agg.build_policy("fedbuff", {"buffer_size": 3, "server_lr": 0.5}, {
        "total_tasks": 5, "staleness": rt.polynomial_staleness(), "device": "cpu"})
    assert (pol.buffer_size, pol.server_lr, pol.total_tasks, pol.device.type) == \
        (3, 0.5, 5, "cpu")
    for alpha in (0.0, 0.5, 1.7):
        for s in (-1, 0, 1, 5):
            assert rt.polynomial_staleness(alpha)(s) == ref_rt.polynomial_staleness(alpha)(s)
    assert rt.__all__ == ref_rt.__all__


def test_a_worker_exception_fails_the_run():
    """A client that raises ends the federation with its exception; it is
    not retried, dropped or counted."""
    def boom(params, rnd):
        raise FloatingPointError("client blew up")

    execs = [TrainExecutor(c, _fixed_train_fn(i)) for i, c in enumerate(CLIENTS)]
    execs[2] = TrainExecutor(CLIENTS[2], boom)
    sim = FLSimulator(execs, FedAvgAggregator("cpu"), SimulationConfig(num_rounds=1),
                      runtime=rt.RuntimeConfig(dropout_prob=0.0), pipelines={},
                      device="cpu")
    with pytest.raises(FloatingPointError, match="blew up"):
        sim.run({k: torch.from_numpy(v.copy()) for k, v in _init().items()})
    assert sim.scheduler.stats.dropouts == sim.scheduler.stats.retries == 0
