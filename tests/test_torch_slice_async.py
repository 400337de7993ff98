"""Port parity, whole slice, the async runtime: the two example jobs that
run it, ``examples/jobs/streaming_aggregation.json`` (qwen1.5-0.5b smoke
width; nf4 downlink with ``norm=fp16,embed=keep`` rules and zlib;
blockwise8 + zlib + crc32 uplink; FedBuff over 3 clients, 6 tasks,
buffer 2, server-side streaming aggregation, a hetero fiber/lte network)
and ``examples/jobs/async_hetero_pipeline.json`` (llama3.2-1b smoke
width; the link-adaptive stage + crc32 uplink; FedBuff over a fiber/3g
network), through ``repro.fl.job`` and ``repro_torch.fl.job`` from the
same initial weights (the reference's, carried across).

1. Fixed updates (no training): everything the runtime computes depends
   only on wire bytes and seeds, and the wire bytes are equal, so the
   timeline (every event's kind, client, simulated time and sequence
   number), ``sim_time_s``, ``runtime_stats``, the staleness list, each
   result's per-hop wire bytes, the traffic totals and the final weights
   are bitwise the reference's.
2. With training: each package trains with its own autograd. The wire
   bytes then differ by a few bytes a message — the loss each result
   carries in its header is printed with another number of digits, and
   zlib compresses slightly different codes — so simulated times differ
   in the last digits. The order of events, the staleness list and every
   count in ``runtime_stats`` are still the reference's; wire bytes and
   simulated times agree within 1e-4 relative (readings: 181 of
   17,521,453 bytes, times within 1.03e-5). The final weights of both
   specs hold C1's bound (``repro_torch.testing.c1_counts``, which the card's
   check uses too): each element within one blockwise8 step of its block
   + 1e-5 relative; at most a 1e-4 share of them (a 4-bit code that
   flipped on a hop: the nf4 downlink here, the 3g clients' nf4 uplink
   in the adaptive spec) one nf4 code gap of its 64-block more; at most
   a 1e-5 share AdamW's sign-flip term 2 * lr * local_steps more.
   Readings on a CPU host: 32 of 1,575,680 elements (2.0e-5) beyond the
   step bound and none beyond the gap bound for streaming_aggregation;
   3 of 1,443,072 (2.1e-6) and none for async_hetero_pipeline.
3. The plain versions run exactly as the path implies on the CPU (the
   counters stay 0), counted from the spec's own rules
   (``repro_torch.testing.async_launches``): the uplink's blockwise8 quantize
   twice a dispatch (the byte-pricing pass and the fold transfer), one
   nf4 quantize a downlink, one nf4 dequantize a downlinked nf4 item,
   one blockwise8 dequantize an uplinked item, no fold kernel.
4. Streaming aggregation on and off, and ``max_concurrency`` 1 and 3,
   give identical timelines and bitwise-equal weights; the job refuses
   ``server_quantized_aggregation`` with FedBuff; the CLI runs the spec.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fl import job as ref_job  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOBS = ROOT / "examples" / "jobs"
SPECS = {name: json.loads((JOBS / f"{name}.json").read_text())
         for name in ("streaming_aggregation", "async_hetero_pipeline")}


@pytest.fixture(scope="module")
def inits():
    return {name: {k: np.asarray(v) for k, v in ref_job.initial_weights(spec).items()}
            for name, spec in SPECS.items()}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fixed_train_fn(index, init_np):
    def train_fn(_params, rnd):
        rng = np.random.default_rng((index, rnd))
        update = {
            k: (v + rng.standard_normal(v.shape).astype(np.float32)
                * np.float32(0.05 * (index + 1))).astype(np.float32)
            for k, v in init_np.items()
        }
        return update, 3 + 5 * index, {}
    return train_fn


def _events(jb):
    return [(e.kind.value, e.client, e.time, e.seq) for e in jb.sim.scheduler.timeline]


def _hops(jb):
    """(client, wire bytes down, wire bytes up) of each completion, in order."""
    out = []
    for e in jb.sim.scheduler.timeline:
        if e.kind.value == "completion":
            h = e.data["result"].headers
            out.append((e.client, h["wire_bytes_down"], h["wire_bytes_up"]))
    return out


def _run(jb, fixed_init=None):
    if fixed_init is not None:
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = _fixed_train_fn(i, fixed_init)
    return jb.run()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fixed_update_run_is_bitwise_the_reference(name, inits):
    spec, init = SPECS[name], inits[name]
    ref_jb = ref_job.build_job(spec)
    port_jb = port_job.build_job(spec, device="cpu", weights=init)
    ref_out, port_out = _run(ref_jb, init), _run(port_jb, init)
    assert port_out["policy"] == ref_out["policy"] == "fedbuff"
    assert _events(port_jb) == _events(ref_jb)
    assert _hops(port_jb) == _hops(ref_jb)
    assert port_out["sim_time_s"] == ref_out["sim_time_s"]
    assert port_out["runtime_stats"] == ref_out["runtime_stats"]
    assert port_out["runtime_stats"]["completions"] == 6
    assert port_out["runtime_stats"]["model_updates"] == 3
    assert port_jb.sim.scheduler.policy.staleness_seen == \
        ref_jb.sim.scheduler.policy.staleness_seen
    assert port_out["wire_bytes"] == ref_out["wire_bytes"]
    assert port_out["telemetry"]["traffic"] == ref_out["telemetry"]["traffic"]
    assert port_out["telemetry"]["runtime"] == ref_out["telemetry"]["runtime"]
    assert port_out.get("adaptive_fmts") == ref_out.get("adaptive_fmts")
    assert list(port_out["final_weights"]) == list(ref_out["final_weights"])
    for k, want in ref_out["final_weights"].items():
        got = _np(port_out["final_weights"][k])
        assert got.dtype == np.float32 and got.tobytes() == np.asarray(want).tobytes(), k


@pytest.fixture(scope="module")
def trained(inits):
    """Each spec trained through both packages once; the port's calls of
    its plain versions counted and its launch counters read."""
    runs = {}
    for name, spec in SPECS.items():
        ref_jb = ref_job.build_job(spec)
        ref_out = ref_jb.run()
        calls = {}
        with pytest.MonkeyPatch.context() as mp:
            for fn in ("quantize_blockwise8", "dequantize_blockwise8",
                       "dequant_accumulate8_into", "quantize_4bit", "dequantize_4bit"):
                orig = getattr(ref, fn)

                def spy(*a, _o=orig, _n=fn, **k):
                    calls[_n] = calls.get(_n, 0) + 1
                    return _o(*a, **k)
                mp.setattr(ref, fn, spy)
            ops.reset_launch_counts()
            port_jb = port_job.build_job(spec, device="cpu", weights=inits[name])
            port_out = port_jb.run()
        runs[name] = (ref_jb, ref_out, port_jb, port_out, calls, ops.launch_counts())
    return runs


@pytest.mark.parametrize("name", sorted(SPECS))
def test_trained_run_matches_the_reference_within_the_c1_bound(name, trained):
    spec = SPECS[name]
    ref_jb, ref_out, port_jb, port_out, calls, launches = trained[name]
    assert launches == {kernel: 0 for kernel in ops.KERNELS}
    if name == "streaming_aggregation":
        # the adaptive uplink's formats follow the links, not the spec's rules
        assert calls == testing.async_launches(spec, list(ref_out["final_weights"]))
    assert [e[:2] + e[3:] for e in _events(port_jb)] == [e[:2] + e[3:] for e in _events(ref_jb)]
    np.testing.assert_allclose([e[2] for e in _events(port_jb)],
                               [e[2] for e in _events(ref_jb)], rtol=1e-4)
    stats = {k: v for k, v in port_out["runtime_stats"].items() if k != "sim_time_s"}
    assert stats == {k: v for k, v in ref_out["runtime_stats"].items() if k != "sim_time_s"}
    assert stats["completions"] == 6 and stats["model_updates"] == 3
    assert port_jb.sim.scheduler.policy.staleness_seen == \
        ref_jb.sim.scheduler.policy.staleness_seen
    np.testing.assert_allclose(port_out["sim_time_s"], ref_out["sim_time_s"], rtol=1e-4)
    np.testing.assert_allclose(port_out["wire_bytes"], ref_out["wire_bytes"], rtol=1e-4)
    np.testing.assert_allclose(sorted(port_out["history"]), sorted(ref_out["history"]),
                               rtol=1e-4)

    assert list(port_out["final_weights"]) == list(ref_out["final_weights"])
    want = {k: torch.from_numpy(np.asarray(v)) for k, v in ref_out["final_weights"].items()}
    got = {k: torch.as_tensor(_np(v)) for k, v in port_out["final_weights"].items()}
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    c1 = testing.c1_counts(want, got,
                              2 * port_job.normalize_spec(spec)["lr"] * spec["local_steps"])
    print(c1)
    assert c1["holds"], c1


def test_trained_adaptive_run_keeps_the_reference_schedule(trained):
    """The adaptive uplink ships fp32 on fiber and nf4 on 3g: only the
    header's loss changes the wire bytes, by a few bytes a message."""
    ref_jb, ref_out, port_jb, port_out, _calls, _launches = trained["async_hetero_pipeline"]
    assert port_out["adaptive_fmts"] == ref_out["adaptive_fmts"]
    assert set(port_out["adaptive_fmts"].values()) == {"fp32", "nf4"}
    assert [e[:2] + e[3:] for e in _events(port_jb)] == [e[:2] + e[3:] for e in _events(ref_jb)]
    for (c1, d1, u1), (c2, d2, u2) in zip(_hops(port_jb), _hops(ref_jb)):
        assert c1 == c2 and d1 == d2 and abs(u1 - u2) <= 64
    np.testing.assert_allclose(port_out["sim_time_s"], ref_out["sim_time_s"], rtol=1e-4)


def _fixed_job(spec, init, **override):
    jb = port_job.build_job({**spec, **override}, device="cpu", weights=init)
    out = _run(jb, init)
    return jb, out


@pytest.mark.parametrize("variant", [{"server_streaming_agg": False},
                                     {"runtime": {**SPECS["streaming_aggregation"]["runtime"],
                                                  "max_concurrency": 1}}],
                         ids=["batch_aggregation", "one_worker"])
def test_variant_gives_the_same_timeline_and_weights(variant, inits):
    spec, init = SPECS["streaming_aggregation"], inits["streaming_aggregation"]
    base_jb, base = _fixed_job(spec, init)
    jb, out = _fixed_job(spec, init, **variant)
    assert _events(jb) == _events(base_jb)
    assert out["runtime_stats"] == base["runtime_stats"]
    assert out["telemetry"]["traffic"] == base["telemetry"]["traffic"]
    for k, want in base["final_weights"].items():
        assert torch.equal(out["final_weights"][k], want), k


def test_job_refuses_quantized_server_aggregation_with_fedbuff():
    spec = {**SPECS["streaming_aggregation"], "server_quantized_aggregation": True}
    with pytest.raises(ValueError, match="server_quantized_aggregation is not supported"):
        port_job.build_job(spec, device="cpu")
    with pytest.raises(ValueError, match="server_quantized_aggregation is not supported"):
        ref_job.build_job(spec)


def test_runtime_key_is_accepted_and_the_live_keys_are_not():
    assert "runtime" not in port_job._NOT_PORTED_KEYS
    port_job.normalize_spec(SPECS["streaming_aggregation"])
    with pytest.raises(NotImplementedError, match="quorum"):
        port_job.normalize_spec({**SPECS["streaming_aggregation"], "quorum": 0.5})


def test_cli_runs_the_spec_on_the_cpu(capsys, tmp_path):
    trace = tmp_path / "trace.json"
    assert port_job.main([str(JOBS / "streaming_aggregation.json"), "--device", "cpu",
                          "--trace", str(trace)]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert "final_weights" not in summary and summary["policy"] == "fedbuff"
    assert summary["runtime_stats"]["completions"] == 6
    assert summary["runtime_stats"]["model_updates"] == 3
    assert summary["sim_time_s"] == summary["runtime_stats"]["sim_time_s"] > 0
    assert summary["messages"] == 12 and summary["round_log"] == []
    events = json.loads(trace.read_text())["traceEvents"]
    # the simulated-clock track: one per client, and wall spans that carry sim_t
    assert any(e.get("pid") == 2 and e.get("name") == "uplink" for e in events)
    assert any("sim_t" in e.get("args", {}) for e in events if e.get("ph") == "X")
