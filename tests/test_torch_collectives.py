"""Port parity, collectives: ``repro_torch.core.collectives`` on two gloo
ranks (CPU) against ``repro.core.collectives`` under ``shard_map`` over a
2-pod mesh of fake host devices, run in a subprocess.

The inputs are the per-pod vectors of ``tests/test_collectives.py``
(10,000 standard normals per pod, seed 0), a vector of 300 blocks less
123 elements with magnitudes from 1e-3 to 1e3, and a two-leaf tree of the
first vector (which tests the leaf order: blocks straddle leaves). Held:

* the wire — each pod's int8 codes and absmax, in the gathered stack
  every rank holds — bitwise;
* the int8 mean bitwise against the reference's (its collective runs the
  einsum under ``jit``, which is the port's plain K-way sum; see
  ``tests/test_torch_agg.py``) and within the reference's own bound of
  the true mean (``tests/test_collectives.py``: max|x| / 127);
* the bucketed mean bitwise equal to the unbucketed one (a bucket is a
  whole number of blocks) and to the reference's bucketed mean;
* the fp32 mean (all_reduce SUM, then / 2) bitwise equal to ``pmean``;
* both ranks' results bitwise equal.
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
from repro_torch.launch import fl_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PODS = 2
#: case -> bucket size of the bucketed mean
BUCKETS = {"n10000": 4096 * 4, "blocks300": 64 * 4096 * 4}

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C
from repro.utils.compat import make_mesh, shard_map

mesh = make_mesh((2, 2), ("pod", "data"))
inputs = np.load(sys.argv[1])
buckets = {"n10000": 4096 * 4, "blocks300": 64 * 4096 * 4}

def per_pod(f, *arrays):
    def g(*xs):
        return jax.tree_util.tree_map(lambda o: o[None], f(*[x[0] for x in xs]))
    sm = shard_map(g, mesh=mesh, in_specs=tuple(P("pod") for _ in arrays),
                   out_specs=P("pod"), check=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(sm)(*map(jnp.asarray, arrays)))

out = {}
for case, bb in buckets.items():
    x = inputs[case]
    q, am = per_pod(C._quantize_flat, x)
    out[f"{case}.codes"], out[f"{case}.absmax"] = q, am
    out[f"{case}.int8"] = per_pod(lambda v: C.quantized_pod_mean(v, "pod"), x)
    out[f"{case}.bucket"] = per_pod(
        lambda v, bb=bb: C.bucketed_quantized_pod_mean(v, bucket_bytes=bb, axis_name="pod"), x)
    out[f"{case}.fp32"] = per_pod(lambda v: jax.lax.pmean(v, "pod"), x)
a, b = inputs["tree.w"], inputs["tree.b"]
tree = per_pod(lambda w, v: C.quantized_fedavg_tree({"w": w, "b": {"a": v}}, axis_name="pod"),
               a, b)
out["tree.int8.w"], out["tree.int8.b"] = tree["w"], tree["b"]["a"]
tree = per_pod(lambda w, v: C.fp32_fedavg_tree({"w": w, "b": {"a": v}}, axis_name="pod"), a, b)
out["tree.fp32.w"], out["tree.fp32.b"] = tree["w"], tree["b"]["a"]
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    n10000 = rng.standard_normal((PODS, 10_000)).astype(np.float32)
    n = 300 * 4096 - 123
    wide = rng.standard_normal((PODS, n)) * 10.0 ** rng.uniform(-3, 3, (PODS, n))
    return {"n10000": n10000, "blocks300": wide.astype(np.float32),
            # leaves of 6,000 and 4,000 elements: block 1 straddles them
            "tree.w": n10000[:, :6000].reshape(PODS, 60, 100), "tree.b": n10000[:, 6000:]}


def _collectives_rank(rank, world, args, inputs):
    """One rank of the port: the same collectives on this rank's slice."""
    torch.set_num_threads(1)
    out = {}
    for case, bb in BUCKETS.items():
        x = torch.from_numpy(inputs[case][rank].copy())
        q, am = C._quantize_flat(x)
        q_all = torch.empty((world, *q.shape), dtype=torch.int8)
        am_all = torch.empty((world, *am.shape), dtype=torch.float32)
        C._all_gather(q, q_all, None)
        C._all_gather(am, am_all, None)
        out[f"{case}.codes"], out[f"{case}.absmax"] = q_all.numpy(), am_all.numpy()
        out[f"{case}.int8"] = C.quantized_pod_mean(x).numpy()
        out[f"{case}.bucket"] = C.bucketed_quantized_pod_mean(x, bucket_bytes=bb).numpy()
        out[f"{case}.fp32"] = C.fp32_fedavg_tree({"x": x})["x"].numpy()
    tree = {"w": torch.from_numpy(inputs["tree.w"][rank].copy()),
            "b": {"a": torch.from_numpy(inputs["tree.b"][rank].copy())}}
    mean = C.quantized_fedavg_tree(tree)
    out["tree.int8.w"], out["tree.int8.b"] = mean["w"].numpy(), mean["b"]["a"].numpy()
    mean = C.fp32_fedavg_tree(tree)
    out["tree.fp32.w"], out["tree.fp32.b"] = mean["w"].numpy(), mean["b"]["a"].numpy()
    flat, _meta, _sizes = C._flatten_tree(tree)
    out["tree.flat_int8"] = C.quantized_pod_mean(flat).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    args = argparse.Namespace(pods=PODS, device="cpu", backend="gloo")
    port = fl_train.launch(args, _collectives_rank, (inputs,))
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    return inputs, dict(np.load(tmp / "ref.npz")), port


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_wire_codes_and_absmax_bitwise_equal_reference(runs, case):
    _inputs_, ref, port = runs
    for rank in range(PODS):
        assert _same(port[rank][f"{case}.codes"], ref[f"{case}.codes"]), rank
        assert _same(port[rank][f"{case}.absmax"], ref[f"{case}.absmax"]), rank


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_int8_mean_bitwise_equals_reference(runs, case):
    inputs, ref, port = runs
    x = inputs[case]
    true = x.astype(np.float64).mean(axis=0)
    bound = float(np.abs(x).max()) / 127.0
    for rank in range(PODS):
        got = port[rank][f"{case}.int8"]
        assert _same(got, ref[f"{case}.int8"][rank]), rank
        assert float(np.abs(got - true).max()) <= bound


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_bucketed_mean_bitwise_equals_unbucketed_and_reference(runs, case):
    _inputs_, ref, port = runs
    for rank in range(PODS):
        got = port[rank][f"{case}.bucket"]
        assert _same(got, port[rank][f"{case}.int8"]), rank
        assert _same(got, ref[f"{case}.bucket"][rank]), rank


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_fp32_mean_bitwise_equals_pmean(runs, case):
    _inputs_, ref, port = runs
    for rank in range(PODS):
        assert _same(port[rank][f"{case}.fp32"], ref[f"{case}.fp32"][rank]), rank


@pytest.mark.parametrize("agg", ["int8", "fp32"])
def test_tree_mean_bitwise_equals_reference(runs, agg):
    """A two-leaf tree: the port flattens in the reference's leaf order, so
    the block that straddles the leaves holds the same elements."""
    _inputs_, ref, port = runs
    for rank in range(PODS):
        for leaf in ("w", "b"):
            assert _same(port[rank][f"tree.{agg}.{leaf}"], ref[f"tree.{agg}.{leaf}"][rank]), \
                (rank, leaf)


def test_ranks_agree_bitwise(runs):
    _inputs_, _ref, port = runs
    for key, value in port[0].items():
        assert _same(port[1][key], value), key


def test_tree_flatten_order_is_the_references():
    """Leaves in ``jax.tree_util`` order (keys sorted at each level), and
    the unflattened tree has the input's structure, shapes and dtypes."""
    rng = np.random.default_rng(3)
    tree_np = {"z": rng.standard_normal((3, 4)).astype(np.float32),
               "a": {"y": rng.standard_normal(5).astype(np.float32),
                     "b": rng.standard_normal((2, 2)).astype(np.float32)},
               "m": [rng.standard_normal(3).astype(np.float32),
                     rng.standard_normal(1).astype(np.float32)]}
    want = np.concatenate([leaf.reshape(-1) for leaf in jax.tree_util.tree_leaves(tree_np)])
    tree = jax.tree_util.tree_map(torch.from_numpy, tree_np)
    flat, meta, sizes = C._flatten_tree(tree)
    assert _same(flat.numpy(), want)
    back = C._unflatten_tree(flat, meta, sizes)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, back)) == \
        jax.tree_util.tree_structure(tree_np)
    for got, leaf in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree_np)):
        assert _same(got.numpy(), leaf)


def test_tree_mean_is_the_flat_mean(runs):
    _inputs_, _ref, port = runs
    flat = np.concatenate([port[0]["tree.int8.b"].reshape(-1), port[0]["tree.int8.w"].reshape(-1)])
    assert _same(flat, port[0]["tree.flat_int8"])
