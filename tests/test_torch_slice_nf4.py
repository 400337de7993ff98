"""Port parity, whole slice, nf4 wire path: ``examples/jobs/wire_pipeline.json``
as it stands (llama3.2-1b smoke width; nf4 + zlib downlink, nf4 + zlib +
crc32 uplink; the default dense ``fedavg`` on the server; 2 rounds, 2
clients) through ``repro.fl.job`` and ``repro_torch.fl.job`` from
identical initial weights (the reference's, carried across).

1. Fixed updates (no training): every client returns the same seeded
   numpy update in both packages, so everything downstream — wire
   bytes, packed codes, zlib streams, the decoded values, the average —
   must match bitwise.
2. With training: each package trains with its own autograd, whose fp32
   sums differ in the last bits. A difference of ~1e-7 can move an
   element across a codebook midpoint, which moves its decoded value by
   one adjacent-code gap of its block — at most the codebook's largest
   gap times the block's absmax — and a different absmax rescales the
   block within that. So after round 1 every element of the global
   weights must lie within one gap + 1e-5 relative of the reference's.
   After round 2 the same bound holds for all but a 1e-5 share of the
   elements, and every element lies within one gap + 2 * lr *
   local_steps + 1e-5 relative: the mechanism the blockwise8 slice test
   states (a value moved in round 1 can flip the sign of a near-zero
   gradient in round 2, and AdamW's normalized step then moves the
   element by ~lr either way). Readings on a CPU host: worst 0.26 gaps
   after round 1, 0.89 after round 2, no element outside one gap. The
   per-round losses agree within 1e-4 relative.
3. On the CPU the kernel launch counters stay 0 and the plain versions
   run: one quantize per message and one dequantize per item on each
   side.
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

SPEC = json.loads((Path(__file__).resolve().parents[1] / "examples" / "jobs"
                   / "wire_pipeline.json").read_text())
LR = port_job.normalize_spec(SPEC)["lr"]
#: share of the final weights' elements allowed outside one code gap of
#: the reference (reading: 0)
FINAL_OUTSIDE_ONE_GAP = 1e-5


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


def test_spec_is_the_nf4_zlib_example():
    p = SPEC["pipeline"]
    assert p["task_data_out"] == ["quantize:nf4", "zlib"]
    assert p["task_result_out"] == ["quantize:nf4", "zlib", "crc32"]
    assert port_job.aggregator_spec(SPEC) == "fedavg"
    assert not port_job.normalize_spec(SPEC)["server_streaming_agg"]


def test_fixed_update_federation_bitwise_equals_reference(init_np):
    ref_jb = ref_job.build_job(SPEC)
    port_jb = port_job.build_job(SPEC, device="cpu", weights=init_np)
    for jb in (ref_jb, port_jb):
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = _fixed_train_fn(i, init_np)
    ref_out, port_out = ref_jb.run(), port_jb.run()
    assert port_out["messages"] == ref_out["messages"] == 2 * SPEC["rounds"] * SPEC["clients"]
    assert port_out["wire_bytes"] == ref_out["wire_bytes"]
    assert list(port_out["final_weights"]) == list(ref_out["final_weights"])
    for name, want in ref_out["final_weights"].items():
        got = _as_np(port_out["final_weights"][name])
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        assert got.tobytes() == np.asarray(want).tobytes(), name


def _gap_bound(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Per element: the nf4 codebook's largest adjacent gap times the
    larger absmax of its 64-block in either tensor (flat layout)."""
    gap = float(np.diff(np.sort(ref.NF4_CODE)).max())

    def block_absmax(a):
        flat = np.abs(a.reshape(-1))
        n = flat.size
        blocks = np.pad(flat, (0, -n % ref.BLOCK4)).reshape(-1, ref.BLOCK4).max(axis=1)
        return np.repeat(blocks, ref.BLOCK4)[:n].reshape(a.shape)

    return gap * np.maximum(block_absmax(want), block_absmax(got))


def test_trained_federation_matches_reference_within_one_code_gap(init_np, monkeypatch):
    calls = {}
    for fn in ("quantize_4bit", "dequantize_4bit"):
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
    n_items = len(init_np)
    msgs = SPEC["rounds"] * SPEC["clients"]
    assert calls == {"quantize_4bit": 2 * msgs, "dequantize_4bit": 2 * msgs * n_items}

    assert port_out["messages"] == ref_out["messages"]
    np.testing.assert_allclose(port_out["history"], ref_out["history"], rtol=1e-4)
    assert len(globals_by_round["ref"]) == len(globals_by_round["port"]) == SPEC["rounds"]
    sign_flips = 2 * LR * SPEC["local_steps"]
    for rnd, (ref_w, port_w) in enumerate(zip(globals_by_round["ref"],
                                              globals_by_round["port"])):
        n = outside = 0
        worst_gaps = 0.0
        for name, want in ref_w.items():
            got = port_w[name]
            assert np.isfinite(got).all()
            gap = _gap_bound(want, got)
            err = np.abs(got - want)
            rel = 1e-5 * np.abs(want)
            n += err.size
            outside += int((err > gap + rel).sum())
            worst_gaps = max(worst_gaps, float((err / np.maximum(gap, 1e-30)).max()))
            cap = gap + rel if rnd == 0 else gap + sign_flips + rel
            assert (err <= cap).all(), (rnd, name, float((err / gap).max()))
        print(f"round {rnd + 1}: {outside} of {n} elements outside one code gap, "
              f"worst {worst_gaps:.4f} gaps")
        assert outside <= FINAL_OUTSIDE_ONE_GAP * n, (rnd, outside, n)
    for name, want in ref_out["final_weights"].items():
        assert _as_np(port_out["final_weights"][name]).tobytes() == \
            globals_by_round["port"][-1][name].tobytes()
