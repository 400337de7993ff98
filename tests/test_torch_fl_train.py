"""Port parity, mesh-view federated trainer: ``repro_torch.launch.fl_train``
on two gloo ranks (CPU) against ``repro.launch.fl_train`` on a 2-pod mesh
of fake host devices (a subprocess), smoke qwen1.5-0.5b, both from the
reference's initial weights, 2 rounds of 2 local AdamW steps at batch 4 x
seq 64, ``--agg fp32`` and ``--agg int8``. Seed 1, whose Dirichlet
partition gives the two pods different data (seed 0 gives both the same
mode). The reference's per-pod losses are read from the devices of its
loss output (device 0 holds pod 0's, which ``fl_train`` prints).

Bounds, and why (as ``tests/test_torch_slice.py`` states them):

* losses: every pod's, every round, within 1e-4 relative;
* ``fp32``: the two packages' autograd sums differ in the last bits
  (``tests/test_torch_model.py``), so the weights after round 1 agree
  within :data:`FP32_ATOL` + 1e-5 relative. With the AdamW state carried
  across rounds, round 2 adds AdamW's sensitivity where |g| is near eps;
  the final weights must lie within 2 * lr * local_steps + 1e-5 relative
  of the reference, and all but a share :data:`OUTSIDE` of them within the
  round-1 bound;
* ``int8``: a difference of ~1e-7 in a pod's delta can flip an int8 code
  at a .5 boundary, which moves the mean by at most one quantization step
  of that pod's block (absmax / 127, divided by the pods and taken here
  as the larger pod's step, from the absmax on the port's wire). So after
  round 1 every element lies within one step + the fp32 bound. A flipped
  code is carried into round 2, where it can flip the sign of a near-zero
  gradient; the final weights lie within 2 steps + 2 * lr * local_steps +
  1e-5 relative, and all but a share :data:`OUTSIDE` within one step +
  the fp32 bound.

On the CPU no kernel launches (the counters stay 0) and both ranks end
each round with the same bits.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.utils.trees import flatten_state_dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = dict(arch="qwen1.5-0.5b", smoke=True, rounds=2, local_steps=2, batch=4, seq=64,
            pods=2, lr=1e-3, alpha=0.5, seed=1)
AGGS = ("fp32", "int8")
#: round-1 fp32 agreement, absolute (plus 1e-5 relative)
FP32_ATOL = 1e-5
#: share of the final weights allowed outside the round-1 bound
OUTSIDE = 1e-5

REFERENCE = r"""
import argparse, sys
import jax, numpy as np
import repro.launch.fl_train as F
from repro.utils.trees import flatten_state_dict

args = dict(arch="qwen1.5-0.5b", smoke=True, rounds=2, local_steps=2, batch=4, seq=64,
            pods=2, lr=1e-3, alpha=0.5, seed=1)
out = {}
for agg in ("fp32", "int8"):
    rounds = []
    make = F.make_fl_round

    def recording(*a, **k):
        fn = make(*a, **k)

        def call(params, opt_state, batches):
            if not rounds:
                out["init"] = {n: np.array(v) for n, v in flatten_state_dict(params).items()}
            params, opt_state, loss = fn(params, opt_state, batches)
            by_device = {s.device.id: float(s.data) for s in loss.addressable_shards}
            rounds.append(({n: np.array(v) for n, v in flatten_state_dict(params).items()},
                           [by_device[0], by_device[2]]))
            return params, opt_state, loss
        return call

    F.make_fl_round = recording
    hist = F.run(argparse.Namespace(agg=agg, **args))["history"]
    F.make_fl_round = make
    for r, (weights, losses) in enumerate(rounds):
        for n, v in weights.items():
            out[f"{agg}.{r}.{n}"] = v
        out[f"{agg}.{r}.losses"] = np.array(losses)
    out[f"{agg}.history"] = np.array(hist)
np.savez(sys.argv[1], **{k: v for k, v in out.items() if k != "init"},
         **{f"init.{n}": v for n, v in out["init"].items()})
print("OK")
"""


def _fl_rank(rank, world, args, init):
    """One rank of the port: for each aggregation, 1 and then 2 rounds from
    the reference's weights, recording this rank's wire absmax."""
    torch.set_num_threads(1)
    recorded = []
    quantize = C._quantize_flat

    def recording(flat):
        q, absmax = quantize(flat)
        recorded.append(absmax.clone())
        return q, absmax

    C._quantize_flat = recording
    ops.reset_launch_counts()
    out = {}
    for agg in AGGS:
        for rounds in (1, 2):
            recorded.clear()
            res = fl_train.run(argparse.Namespace(**{**vars(args), "agg": agg,
                                                     "rounds": rounds}),
                               rank=rank, world=world, init_params=init)
            out[f"{agg}.{rounds}.history"] = res["history"]
            out[f"{agg}.{rounds}.weights"] = {
                n: v.detach().numpy().copy() for n, v in flatten_state_dict(res["params"]).items()}
            out[f"{agg}.{rounds}.absmax"] = [a.numpy() for a in recorded]
    out["launches"] = ops.launch_counts()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fl_train")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp / "ref.npz")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    init = {k[len("init."):]: v for k, v in ref.items() if k.startswith("init.")}
    args = argparse.Namespace(device="cpu", backend="gloo", **ARGS)
    port = fl_train.launch(args, _fl_rank, (init,))
    return ref, port


def _block_step(absmaxes: list[np.ndarray], n: int) -> np.ndarray:
    """Per element of the flat delta: the larger pod's absmax / 127 of the
    4096-block it falls in."""
    am = np.maximum(*absmaxes).astype(np.float64)
    return np.repeat(am / 127.0, 4096)[:n]


def _flat(weights: dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([weights[n].reshape(-1) for n in sorted(weights)]).astype(np.float64)


def _reference_weights(ref: dict, agg: str, rnd: int, names) -> dict[str, np.ndarray]:
    return {n: ref[f"{agg}.{rnd}.{n}"] for n in names}


@pytest.mark.parametrize("agg", AGGS)
def test_per_pod_losses_match_reference(runs, agg):
    ref, port = runs
    for rank in range(ARGS["pods"]):
        for rounds in (1, 2):
            want = [ref[f"{agg}.{r}.losses"][rank] for r in range(rounds)]
            np.testing.assert_allclose(port[rank][f"{agg}.{rounds}.history"], want, rtol=1e-4)
    # what each package reports is pod 0's
    np.testing.assert_allclose(ref[f"{agg}.history"],
                               [ref[f"{agg}.{r}.losses"][0] for r in range(ARGS["rounds"])])


@pytest.mark.parametrize("agg", AGGS)
def test_ranks_end_every_round_bitwise_equal(runs, agg):
    _ref, port = runs
    for rounds in (1, 2):
        a, b = port[0][f"{agg}.{rounds}.weights"], port[1][f"{agg}.{rounds}.weights"]
        assert list(a) == list(b)
        for name in a:
            assert a[name].tobytes() == b[name].tobytes(), (rounds, name)


@pytest.mark.parametrize("agg", AGGS)
def test_weights_match_reference(runs, agg):
    ref, port = runs
    names = sorted(port[0][f"{agg}.1.weights"])
    for rounds in (1, 2):
        got = _flat(port[0][f"{agg}.{rounds}.weights"])
        want = _flat(_reference_weights(ref, agg, rounds - 1, names))
        err = np.abs(got - want)
        base = FP32_ATOL + 1e-5 * np.abs(want)
        # each round's quantization step, from the wire of both ranks
        steps = [_block_step([port[r][f"{agg}.{rounds}.absmax"][i] for r in range(2)], got.size)
                 for i in range(rounds)] if agg == "int8" else [np.zeros_like(got)] * rounds
        one = np.maximum.reduce(steps) + base
        outside = int((err > one).sum())
        print(f"{agg} round {rounds}: max |err| {err.max():.3g}, worst "
              f"{float((err / one).max()):.3f} of the round-1 bound, {outside} of {err.size} "
              "elements outside it")
        if rounds == 1:
            assert outside == 0, float((err / one).max())
        else:
            cap = sum(steps) + 2 * ARGS["lr"] * ARGS["local_steps"] + 1e-5 * np.abs(want)
            assert (err <= cap).all(), float(err.max())
            assert outside <= OUTSIDE * err.size, outside


def test_no_kernel_launches_on_the_cpu(runs):
    _ref, port = runs
    for rank in range(ARGS["pods"]):
        assert port[rank]["launches"] == {name: 0 for name in ops.KERNELS}


def test_cli_runs_two_ranks_on_the_cpu():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--smoke", "--device", "cpu",
         "--rounds", "2", "--batch", "2", "--seq", "16", "--agg", "int8-bucket", "--seed", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [line.split()[:3] for line in lines[:2]] == [
        ["round", "0", "agg=int8-bucket"], ["round", "1", "agg=int8-bucket"]]
    assert lines[-1].startswith("final loss ")


def test_backend_choice_never_switches_quietly(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert fl_train.resolve_backend(None, cpu, 2) == "gloo"
    assert fl_train.resolve_backend("gloo", cpu, 2) == "gloo"
    assert fl_train.resolve_backend("gloo", cuda, 2) == "gloo"
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl_train.resolve_backend("nccl", cpu, 2)
    with pytest.raises(ValueError, match="unknown backend"):
        fl_train.resolve_backend("mpi", cpu, 2)
    monkeypatch.setattr(fl_train.dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(fl_train.torch.cuda, "device_count", lambda: 2)
    assert fl_train.resolve_backend(None, cuda, 2) == "nccl"
    with pytest.raises(ValueError, match="one card per rank"):
        fl_train.resolve_backend(None, cuda, 3)
    with pytest.raises(ValueError, match="one card per rank"):
        fl_train.resolve_backend("nccl", torch.device("cuda", 0), 2)
    monkeypatch.setattr(fl_train.dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        fl_train.resolve_backend("nccl", cuda, 2)


def test_run_checks_the_group_size_and_the_aggregation():
    args = argparse.Namespace(device="cpu", backend="gloo", agg="int8", **ARGS)
    with pytest.raises(ValueError, match="3 ranks for 2 pods"):
        fl_train.run(args, rank=0, world=3)
    with pytest.raises(ValueError, match="unknown aggregation"):
        fl_train.make_fl_round(None, local_steps=2, lr=1e-3, agg="int4")


def _failing_rank(rank, world, args):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()   # waits for rank 1, which never comes
    return rank


def test_a_failing_rank_makes_launch_raise():
    """Whichever rank's error surfaces first (rank 1's own, or rank 0's
    broken barrier), the launcher raises instead of returning."""
    args = argparse.Namespace(pods=2, device="cpu", backend="gloo")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        fl_train.launch(args, _failing_rank)
