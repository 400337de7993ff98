"""Port parity, whole slice, the LoRA plane: ``examples/jobs/lora_federation.json``
as it stands (llama3.2-1b smoke width; ``lora:8 -> quantize:nf4 -> crc32``
uplink, no downlink stage; ``lora-fedavg`` folding the uplink in wire
form; 4 clients, 2 rounds) through ``repro.fl.job`` and
``repro_torch.fl.job`` from the reference's initial weights.

The two packages decompose with two SVDs (LAPACK through jax and through
torch), so factor bytes agree only numerically. What each side must give:

1. Fixed updates (no training; each client a seeded update of its
   own): the same messages; every uplink envelope frames the same item
   with the same body length, and every envelope without a factor pair
   — the three nf4 items an uplink at smoke width (the stacked
   ``(2, 256)`` norms are below rank 8, plus ``final_norm``) — is
   bitwise the reference's; the per-hop byte totals differ only by the
   decimal digits of the factor items' crc32 values
   (``repro_torch.testing.lora_wire_compare``, which the card's check uses
   too). Global weights: the nf4-folded items bitwise (the plain FedAvg
   is numpy's arithmetic), every factored item within its Wedin bound
   (``repro_torch.testing.lora_fixed_bounds``: each SVD backward stable to
   ``eps sqrt(max(m, n)) sigma_1``, amplified by ``1 + 2 sigma_1 /
   (sigma_8 - sigma_9)`` of each client's update, which is 75-5,638
   here). Readings on a CPU host: 0.6-1.6 % of the bound (3.6e-5
   relative at worst). A truncation this ill-conditioned cannot tell a
   TF32 merge from a second exact SVD, so the same run is made again
   with a well-separated rank-8 part in every update
   (``repro_torch.testing.separated_train_fn``): its bound is ~1.8e-5
   relative, the readings 4-7 % of it. Planted faults — factors rounded
   through bf16, the merge's operands rounded to TF32, one client's
   weight off by 0.2 % or 2 % — must leave items beyond the bound
   (every item, with the separated updates: 6.5-130 x).
2. Trained: each package trains with its own autograd (C1). The inputs
   to the SVDs then differ by ~1e-7 relative, and the truncation
   amplifies that the same way. Every item within ``LORA_TRAINED_TOL`` =
   2e-3 relative Frobenius after round 2 (reading: 4.3e-4, lm_head);
   losses within 1e-4 relative.
3. The plain 4-bit versions run as the path implies
   (``repro_torch.testing.lora_launches``): one quantize and one dequantize (on
   the server) a leftover item an uplink; the launch counters stay 0.
4. One round of 4 clients gives every global matrix rank exactly 8
   (ROADMAP C9): the clients low-rank their full trained weights, and
   the iid partition gives them the same data (C7).
"""
import contextlib
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
SPEC_PATH = ROOT / "examples" / "jobs" / "lora_federation.json"
SPEC = json.loads(SPEC_PATH.read_text())

LORA_TRAINED_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_pool():
    """One thread in torch's intra-op pool and in scipy's OpenBLAS pool
    (the reference's SVDs run there) for this file's tests. Two SVD
    federations at once on a shared 8-core CPU host, each with a pool
    per core, took 170-238 s each against 2.7-8.4 s alone.
    The cap reaches OpenBLAS only once ``scipy.linalg`` has loaded it,
    hence the import first. The arithmetic is the same either way."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        import scipy.linalg  # noqa: F401
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    with limits:
        yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def init_np():
    return {k: np.asarray(v) for k, v in ref_job.initial_weights(SPEC).items()}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


#: the fixed client updates: Gaussian (``fixed_train_fn``) and the same
#: with a well-separated rank-8 part (``separated_train_fn``)
UPDATES = {"gaussian": testing.fixed_train_fn, "separated": testing.separated_train_fn}


def _jobs(spec, init_np, fixed):
    """Reference and port jobs from the same weights, each uplink logged;
    ``fixed`` names the clients' fixed update (:data:`UPDATES`), or None
    to train."""
    jobs = (ref_job.build_job(spec), port_job.build_job(spec, device="cpu", weights=init_np))
    logs = []
    for jb in jobs:
        logs.append(testing.envelope_log(jb.sim.proxies[0].pipelines["task_result"]))
        if fixed:
            for i, proxy in enumerate(jb.sim.proxies):
                proxy.executor.train_fn = UPDATES[fixed](init_np, i, 0.05 * (i + 1))
    return jobs, logs


@pytest.fixture(scope="module")
def fixed_runs(init_np):
    """``{update: (reference result, port result, their uplink logs)}``,
    each federation run once."""
    cache = {}

    def get(update):
        if update not in cache:
            (ref_jb, port_jb), logs = _jobs(SPEC, init_np, fixed=update)
            cache[update] = (ref_jb.run(), port_jb.run(), logs)
        return cache[update]
    return get


def _factored_errors(init_np, ref_out, port_out, update):
    """Per factored item: the port's relative error against the
    reference's global weights, and its :func:`lora_fixed_bounds`."""
    want = {k: np.asarray(v) for k, v in ref_out["final_weights"].items()}
    got = {k: _np(v) for k, v in port_out["final_weights"].items()}
    factored = testing.lora_factor_bytes(SPEC, {k: v.shape for k, v in init_np.items()})[1]
    errs = testing.relative_errors(want, got)
    bounds = testing.lora_fixed_bounds(SPEC, init_np, want, factored, UPDATES[update])
    print({k: f"{errs[k]:.2e} of {bounds[k]:.2e}" for k in factored})
    return want, got, factored, errs, bounds


def test_spec_is_the_lora_example():
    assert SPEC["pipeline"] == {"task_result_out": ["lora:8", "quantize:nf4", "crc32"]}
    assert port_job.aggregator_spec(SPEC) == "lora-fedavg"
    pls = port_job.build_pipelines_from_spec(SPEC, device="cpu")
    assert pls["task_result"].decode_values is False and pls["task_data"].stages == []
    assert (SPEC["clients"], SPEC["rounds"]) == (4, 2)


def _check_fixed_update_federation(init_np, fixed_runs, update):
    ref_out, port_out, (ref_log, port_log) = fixed_runs(update)
    uplinks = SPEC["rounds"] * SPEC["clients"]
    assert port_out["messages"] == ref_out["messages"] == 2 * uplinks
    cmp = testing.lora_wire_compare(ref_log, port_log)
    print(cmp)
    assert cmp["holds"], cmp
    assert cmp["envelopes"] == uplinks * len(init_np)
    assert cmp["bitwise"] == uplinks * 3            # the nf4 items
    assert port_out["wire_bytes"] - ref_out["wire_bytes"] == cmp["crc_digit_diff"]
    want, got, factored, errs, bounds = _factored_errors(init_np, ref_out, port_out, update)
    assert list(got) == list(want)
    assert sorted(set(want) - set(factored)) == [
        "blocks.attn_norm", "blocks.mlp_norm", "embed.final_norm"]
    for name in set(want) - set(factored):
        assert got[name].tobytes() == want[name].tobytes(), name
    for name in factored:
        assert errs[name] <= bounds[name], (name, errs[name], bounds[name])


def test_fixed_update_federation_matches_reference(init_np, fixed_runs):
    _check_fixed_update_federation(init_np, fixed_runs, "gaussian")


def test_fixed_separated_update_federation_matches_reference(init_np, fixed_runs):
    """The same with each client's update carrying a well-separated
    rank-8 part: the truncation is well conditioned and the bound ~60 x
    tighter (readings on a CPU host: 4-7 % of it, ~1e-6 relative)."""
    _check_fixed_update_federation(init_np, fixed_runs, "separated")


def _tf32(t):
    """Round fp32 to TF32's 10-bit mantissa, to nearest (what a TF32
    matrix product does to its operands)."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _plant(monkeypatch, fault):
    from repro_torch.fl.aggregator import LoRAFedAvgAggregator

    decompose, merge = ops.low_rank_decompose, ops.low_rank_merge
    weight_of = LoRAFedAvgAggregator.weight_of
    if fault == "bf16_factors":
        monkeypatch.setattr(ops, "low_rank_decompose", lambda x, r: tuple(
            t.to(torch.bfloat16).to(torch.float32) for t in decompose(x, r)))
    elif fault == "tf32_merge":
        monkeypatch.setattr(ops, "low_rank_merge",
                            lambda a, b, scale: merge(_tf32(a), _tf32(b), scale))
    else:                                   # "client_weight_<percent>"
        off = 1 + float(fault.rsplit("_", 1)[1]) / 100
        monkeypatch.setattr(LoRAFedAvgAggregator, "weight_of", lambda self, meta: weight_of(
            self, meta) * (off if meta.get("client") == "site-0" else 1.0))


@pytest.mark.parametrize("update,fault", [
    ("gaussian", "bf16_factors"), ("gaussian", "client_weight_2"),
    ("separated", "bf16_factors"), ("separated", "tf32_merge"),
    ("separated", "client_weight_0.2")])
def test_planted_fault_breaks_the_fixed_update_bound(init_np, fixed_runs, monkeypatch,
                                                     update, fault):
    """The bound is no blanket: a port whose factors pass through bf16,
    whose merge runs under TF32, or that weighs one client off by a few
    tenths of a percent, leaves factored items beyond it. With Gaussian
    updates the truncation is too ill-conditioned (``sigma_1 / (sigma_8 -
    sigma_9)`` up to 5,638) to tell a TF32 merge (2.9e-4 relative, 4-34 %
    of the bound) or a 0.2 % weight from a second exact SVD; with the
    separated updates every such fault reads 6.5-130 x its bound."""
    ref_out = fixed_runs(update)[0]
    _plant(monkeypatch, fault)
    port_jb = port_job.build_job(SPEC, device="cpu", weights=init_np)
    for i, proxy in enumerate(port_jb.sim.proxies):
        proxy.executor.train_fn = UPDATES[update](init_np, i, 0.05 * (i + 1))
    port_out = port_jb.run()
    *_, factored, errs, bounds = _factored_errors(init_np, ref_out, port_out, update)
    beyond = [n for n in factored if errs[n] > bounds[n]]
    assert beyond, {n: errs[n] / bounds[n] for n in factored}
    if update == "separated":
        assert beyond == factored


def test_trained_federation_matches_reference_within_bound(init_np, monkeypatch):
    calls = {}
    for fn in ("quantize_4bit", "dequantize_4bit"):
        orig = getattr(ref, fn)

        def spy(*a, _o=orig, _n=fn, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _o(*a, **k)
        monkeypatch.setattr(ref, fn, spy)
    ops.reset_launch_counts()
    globals_by_round = {"ref": [], "port": []}
    (ref_jb, port_jb), _ = _jobs(SPEC, init_np, fixed=None)
    for key, jb in (("ref", ref_jb), ("port", port_jb)):
        jb.sim.controller.on_round_end = (
            lambda rnd, weights, results, _k=key: globals_by_round[_k].append(
                {n: _np(v).copy() for n, v in weights.items()}))
    ref_out, port_out = ref_jb.run(), port_jb.run()

    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    shapes = {k: v.shape for k, v in init_np.items()}
    assert calls == testing.lora_launches(SPEC, shapes) == {
        "quantize_4bit": 24, "dequantize_4bit": 24}
    assert port_out["messages"] == ref_out["messages"]
    np.testing.assert_allclose(port_out["history"], ref_out["history"], rtol=1e-4)
    for rnd, (want, got) in enumerate(zip(globals_by_round["ref"], globals_by_round["port"])):
        errs = testing.relative_errors(want, got)
        print(f"round {rnd + 1}: worst {max(errs.values()):.2e}")
        assert all(np.isfinite(v).all() for v in got.values())
        assert max(errs.values()) <= LORA_TRAINED_TOL, (rnd, errs)
    # C9: after round 1 every global matrix is rank 8 in both packages
    for w in (globals_by_round["ref"][0], globals_by_round["port"][0]):
        for name, v in w.items():
            if v.ndim >= 2 and min(v.reshape(-1, v.shape[-1]).shape) > 8:
                s = np.linalg.svd(v.reshape(-1, v.shape[-1]).astype(np.float64),
                                  compute_uv=False)
                assert s[8] <= 1e-5 * s[0] < s[7], name


def test_full_width_lora_launches_follow_the_shapes():
    """At full width the stacked norms ``(16, 2048)`` are decomposed too;
    only ``embed.final_norm`` reaches nf4: one B4 and one B5 an uplink."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM

    shapes = DecoderLM(get_config("llama3.2-1b")).param_shapes()
    assert testing.lora_launches(SPEC, shapes) == {"quantize_4bit": 8, "dequantize_4bit": 8}


def test_cli_runs_the_spec_unchanged_on_the_cpu(capsys):
    assert port_job.main([str(SPEC_PATH), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert "final_weights" not in summary
    assert summary["messages"] == 2 * SPEC["rounds"] * SPEC["clients"]
    assert len(summary["history"]) == SPEC["rounds"] * SPEC["clients"]
    assert all(np.isfinite(summary["history"]))
