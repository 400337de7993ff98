"""Port parity, whole slice, the paper's filter form of two-way quantization:
``examples/jobs/legacy_quantized.json`` as it stands (llama3.2-1b smoke
width, ``"quantization": {"fmt": "blockwise8"}``: a QuantizeFilter on
both egress points and a DequantizeFilter on both ingress points, dense
``fedavg``; 2 rounds, 2 clients) through ``repro.fl.job`` and
``repro_torch.fl.job`` from identical initial weights (the reference's,
carried across), in ``container`` and ``regular`` transmission, and the
``dp_sigma``, ``error_feedback`` and adaptive variants of the spec.

1. Fixed updates (no training): every client returns the same seeded
   numpy update in both packages, so everything downstream must match
   bitwise — the final weights, the wire bytes of every hop
   (``wire_bytes_down`` / ``wire_bytes_up`` of each result,
   ``TrafficStats``), and the MemoryMeter's accounting, which in regular
   mode holds the whole blob three times and in both modes the filter's
   materialized payload (``held_bytes``).
2. With training: each package trains with its own autograd, so the
   global weights may differ by one quantization step per block after
   round 1 and drift further in round 2 — the bound (C1) that
   ``tests/test_torch_slice.py`` states, unchanged. The per-round losses
   agree within 1e-4 relative. On the CPU the kernel launch counters
   stay 0, and the plain versions run once per item per direction:
   the filters quantize and dequantize item by item, as the
   reference's do.
3. The entry point: ``python -m repro_torch.fl.job SPEC.json --device
   cpu`` runs the spec unchanged and prints the reference's summary.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fl import job as ref_job  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SPEC_PATH = Path(__file__).resolve().parents[1] / "examples" / "jobs" / "legacy_quantized.json"
SPEC = json.loads(SPEC_PATH.read_text())
LR = port_job.normalize_spec(SPEC)["lr"]
#: share of the final weights' elements allowed outside one quantization
#: step of the reference (test_torch_slice.py's bound)
ROUND2_OUTSIDE_ONE_STEP = 1e-5

VARIANTS = {
    "container": {},
    "regular": {"transmission": "regular"},
    "dp_sigma": {"dp_sigma": 0.01},
    "error_feedback": {"quantization": {"fmt": "blockwise8", "error_feedback": True},
                       "transmission": "regular"},
    "adaptive": {"quantization": {"fmt": "adaptive", "bandwidth_mbps": 10.0}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file's federations. The suite
    runs six workers on a shared CPU, and a pool per core in each
    oversubscribes it: on an 8-core CPU host,
    ``test_torch_slice_legacy.py`` beside the reference's
    ``lora_federation.json`` job took 122.5 s and the job 115.2 s; with
    this cap, 30.4 s and 33.3 s. No check depends on the
    pool's size: fixed-update runs do no matrix products, and trained
    runs are held to stated bounds."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def init_np():
    return {k: np.asarray(v) for k, v in ref_job.initial_weights(SPEC).items()}


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


def _as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _run_fixed(jb, init_np):
    """Run ``jb`` with fixed updates; returns its output and each
    result's per-hop wire bytes, round by round."""
    hops = []
    for i, proxy in enumerate(jb.sim.proxies):
        proxy.executor.train_fn = _fixed_train_fn(i, init_np)
    jb.sim.controller.on_round_end = lambda rnd, weights, results: hops.append(
        [(r.headers["wire_bytes_down"], r.headers["wire_bytes_up"]) for r in results])
    return jb.run(), hops


def test_spec_is_the_legacy_two_way_example():
    assert SPEC["quantization"] == {"fmt": "blockwise8"} and "pipeline" not in SPEC
    assert SPEC["transmission"] == "container" and SPEC["clients"] == 2
    assert port_job.aggregator_spec(SPEC) == ref_job.aggregator_spec(SPEC) == "fedavg"
    jb = port_job.build_job(SPEC, device="cpu")
    names = {hop: [s.name for s in p.stages] for hop, p in jb.sim.pipelines.items()}
    assert names == {"task_data": ["filter:QuantizeFilter", "filter:DequantizeFilter"],
                     "task_result": ["filter:QuantizeFilter", "filter:DequantizeFilter"]}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fixed_update_federation_bitwise_equals_reference(variant, init_np):
    spec = {**SPEC, **VARIANTS[variant]}
    (ref_out, ref_hops) = _run_fixed(ref_job.build_job(spec), init_np)
    (port_out, port_hops) = _run_fixed(
        port_job.build_job(spec, device="cpu", weights=init_np), init_np)
    assert port_out["messages"] == ref_out["messages"] == 2 * SPEC["rounds"] * SPEC["clients"]
    assert port_hops == ref_hops
    assert port_out["wire_bytes"] == ref_out["wire_bytes"] == \
        sum(d + u for rnd in port_hops for d, u in rnd)
    assert port_out["telemetry"]["traffic"] == ref_out["telemetry"]["traffic"]
    assert port_out["telemetry"]["memory"] == ref_out["telemetry"]["memory"]
    assert port_out.get("adaptive_fmts") == ref_out.get("adaptive_fmts")
    assert list(port_out["final_weights"]) == list(ref_out["final_weights"])
    for name, want in ref_out["final_weights"].items():
        got = _as_np(port_out["final_weights"][name])
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        assert got.tobytes() == np.asarray(want).tobytes(), name
    if variant == "adaptive":
        assert set(port_out["adaptive_fmts"].values()) == {"nf4"}


def test_regular_mode_holds_more_than_container_and_sends_other_frames(init_np):
    outs = {}
    for mode in ("container", "regular"):
        jb = port_job.build_job({**SPEC, "transmission": mode}, device="cpu", weights=init_np)
        outs[mode] = _run_fixed(jb, init_np)[0]
    peak = {m: o["telemetry"]["memory"]["peak"] for m, o in outs.items()}
    assert peak["regular"] > peak["container"]
    assert outs["regular"]["wire_bytes"] != outs["container"]["wire_bytes"]
    for name, w in outs["container"]["final_weights"].items():
        assert torch.equal(w, outs["regular"]["final_weights"][name]), name


def _block_absmax(a: np.ndarray) -> np.ndarray:
    """Per-element absmax of the 4096-block it falls in (flat layout)."""
    flat = np.abs(a.reshape(-1))
    n = flat.size
    pad = -n % ref.BLOCK8
    blocks = np.pad(flat, (0, pad)).reshape(-1, ref.BLOCK8).max(axis=1)
    return np.repeat(blocks, ref.BLOCK8)[:n].reshape(a.shape)


def test_trained_federation_matches_reference_within_the_c1_bound(init_np, monkeypatch):
    calls = {}
    for fn in ("quantize_blockwise8", "dequantize_blockwise8", "dequant_accumulate8_into"):
        orig = getattr(ref, fn)

        def spy(*a, _o=orig, _n=fn, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _o(*a, **k)
        monkeypatch.setattr(ref, fn, spy)
    ops.reset_launch_counts()

    globals_by_round = {"ref": [], "port": []}
    ref_jb = ref_job.build_job(SPEC)
    port_jb = port_job.build_job(SPEC, device="cpu", weights=init_np)
    for key, jb in (("ref", ref_jb), ("port", port_jb)):
        jb.sim.controller.on_round_end = (
            lambda rnd, weights, results, _k=key: globals_by_round[_k].append(
                {n: _as_np(v).copy() for n, v in weights.items()}))
    ref_out, port_out = ref_jb.run(), port_jb.run()

    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    # the filters work item by item: one quantize per item at each egress
    # point, one dequantize per item at each ingress point
    per_direction = SPEC["rounds"] * SPEC["clients"] * len(init_np)
    assert calls == {"quantize_blockwise8": 2 * per_direction,
                     "dequantize_blockwise8": 2 * per_direction}

    np.testing.assert_allclose(port_out["history"], ref_out["history"], rtol=1e-4)
    assert len(globals_by_round["ref"]) == len(globals_by_round["port"]) == SPEC["rounds"]
    for rnd, (ref_w, port_w) in enumerate(zip(globals_by_round["ref"],
                                              globals_by_round["port"])):
        n = outside = 0
        worst_steps = 0.0
        for name, want in ref_w.items():
            got = port_w[name]
            assert np.isfinite(got).all()
            step = np.maximum(_block_absmax(want), _block_absmax(got)) / 127.0
            err = np.abs(got - want)
            rel = 1e-5 * np.abs(want)
            n += err.size
            outside += int((err > step + rel).sum())
            worst_steps = max(worst_steps, float((err / np.maximum(step, 1e-30)).max()))
            if rnd == 0:
                assert (err <= step + rel).all(), (name, float((err / step).max()))
            else:
                sign_flips = 2 * LR * SPEC["local_steps"]
                assert (err <= 2 * step + sign_flips + rel).all(), (name, float(err.max()))
        print(f"round {rnd + 1}: {outside} of {n} elements outside one step, "
              f"worst {worst_steps:.4f} steps")
        assert outside <= ROUND2_OUTSIDE_ONE_STEP * n, (rnd, outside, n)


def test_cli_runs_the_spec_unchanged_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.fl.job SPEC.json --device cpu --trace OUT``:
    the reference's summary keys, without weights, and the numbers of
    ``run_job`` on the same spec (the wire bytes depend on the values
    only through the loss in each result's headers)."""
    trace = tmp_path / "trace.json"
    assert port_job.main([str(SPEC_PATH), "--device", "cpu", "--trace", str(trace)]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert "final_weights" not in summary
    assert {"history", "messages", "wire_bytes", "round_log", "telemetry",
            "trace"} <= set(summary)
    assert summary["messages"] == 2 * SPEC["rounds"] * SPEC["clients"]
    assert len(summary["history"]) == SPEC["rounds"] * SPEC["clients"]
    assert all(np.isfinite(summary["history"]))
    direct = port_job.run_job(SPEC, device="cpu")
    assert summary["wire_bytes"] == direct["wire_bytes"]
    assert summary["history"] == direct["history"]
    assert json.loads(trace.read_text())["traceEvents"]


def test_cli_without_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_job.main([str(SPEC_PATH)])


def test_legacy_keys_are_refused_where_the_reference_refuses_them():
    for bad in ({"pipeline": {"task_data": ["quantize:nf4"]}},
                {"pipeline": {"task_data": ["quantize:nf4"]}, "quantization": None,
                 "dp_sigma": 0.1}):
        spec = {**SPEC, **bad}
        with pytest.raises(ValueError, match="replaces the legacy"):
            ref_job.build_job(spec)
        with pytest.raises(ValueError, match="replaces the legacy"):
            port_job.build_job(spec, device="cpu")
    with pytest.raises(ValueError, match="no streaming-pipeline form"):
        port_job.build_pipelines_from_spec(SPEC, device="cpu")
    for q in ({"fmt": "adaptive", "error_feedback": True},):
        with pytest.raises(ValueError, match="does not compose"):
            port_job.build_job({**SPEC, "quantization": q}, device="cpu")
    with pytest.raises(ValueError, match="does not compose"):
        port_job.build_job({**SPEC, "quantization": {"fmt": "adaptive"},
                            "server_quantized_aggregation": True}, device="cpu")
    assert port_job.aggregator_spec({**SPEC, "server_quantized_aggregation": True}) == \
        ref_job.aggregator_spec({**SPEC, "server_quantized_aggregation": True}) == \
        "quantized-fedavg"
