"""Port parity, collectives at 4 and 8 pods (ROADMAP C2): the int8 pod mean
of ``repro_torch.core.collectives`` on 4 and 8 gloo ranks (CPU) against
``repro.core.collectives.quantized_pod_mean`` under ``shard_map`` over 8
fake host devices (meshes (pod 4, data 2) and (pod 8, data 1)), run in a
subprocess.

The input is 8 pods of 300 blocks less 123 elements with magnitudes from
1e-3 to 1e3 (seed 0); the K = 4 pods are the first four. One launch of 8
gloo ranks runs both pod counts: the 8-pod mean over the whole group,
the 4-pod mean over a group of ranks 0-3. Held:

* the wire (each pod's int8 codes and absmax, as every rank gathers
  them) bitwise at both pod counts;
* at 4 pods the mean bitwise: under ``jit`` the reference's einsum is K
  sequential folds at K <= 4 (``tests/test_torch_agg.py``), which is the
  port's plain K-way sum;
* at 8 pods XLA contracts in another order, so the mean is held within
  ``2 (K + 2)`` units of ``2**-24 * sum_k |q_k| s_k`` (two forms, each
  within K + 2 roundings of the exact sum; ``tests/test_torch_agg.py``'s
  tolerance, which this file shares);
* every rank's mean bitwise equal to rank 0's.

Each rank and the reference subprocess run with one thread (port rule 7).
"""
import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:   # the reference runs in a subprocess
    pytest.skip("the reference needs jax", allow_module_level=True)

from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PODS = (4, 8)
CASES = ("blocks300",)

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C
from repro.utils.compat import make_mesh, shard_map

inputs = np.load(sys.argv[1])
out = {}
for k in (4, 8):
    mesh = make_mesh((k, 8 // k), ("pod", "data"))

    def per_pod(f, x):
        def g(v):
            return jax.tree_util.tree_map(lambda o: o[None], f(v[0]))
        sm = shard_map(g, mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod"), check=False)
        return jax.tree_util.tree_map(np.asarray, jax.jit(sm)(jnp.asarray(x)))

    for case in ("blocks300",):
        x = inputs[case][:k]
        q, am = per_pod(C._quantize_flat, x)
        out[f"{k}.{case}.codes"], out[f"{k}.{case}.absmax"] = q, am
        out[f"{k}.{case}.int8"] = per_pod(lambda v: C.quantized_pod_mean(v, "pod"), x)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    k = max(PODS)
    n = 300 * 4096 - 123
    wide = rng.standard_normal((k, n)) * 10.0 ** rng.uniform(-3, 3, (k, n))
    return {"blocks300": wide.astype(np.float32)}


def _pods_rank(rank, world, args, inputs):
    """One rank of the port: codes, absmax and the int8 mean of its pod,
    over all ranks (8 pods) and, on ranks 0-3, over their group (4 pods)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    groups = {8: None, 4: dist.new_group(list(range(4)))}   # every rank creates it
    out = {}
    for k, group in groups.items():
        if rank >= k:
            continue
        for case in CASES:
            x = torch.from_numpy(inputs[case][rank].copy())
            q, am = C._quantize_flat(x)
            q_all = torch.empty((k, *q.shape), dtype=torch.int8)
            am_all = torch.empty((k, *am.shape), dtype=torch.float32)
            C._all_gather(q, q_all, group)
            C._all_gather(am, am_all, group)
            out[f"{k}.{case}.codes"], out[f"{k}.{case}.absmax"] = q_all.numpy(), am_all.numpy()
            out[f"{k}.{case}.int8"] = C.quantized_pod_mean(x, group).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives_pods")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH="src", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    args = argparse.Namespace(pods=max(PODS), device="cpu", backend="gloo")
    ranks = fl_train.launch(args, _pods_rank, (inputs,))
    port = {k: [{key[len(f"{k}."):]: v for key, v in r.items() if key.startswith(f"{k}.")}
                for r in ranks[:k]] for k in PODS}
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    return inputs, dict(np.load(tmp / "ref.npz")), port


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _tolerance(codes: np.ndarray, absmax: np.ndarray) -> np.ndarray:
    """``2 (K + 2) 2**-24 sum_k |q_k| s_k`` per element, s_k = absmax_k /
    127 / K in float64, plus the smallest normal float32."""
    k = codes.shape[0]
    s = absmax.astype(np.float64) * (np.float64(ref.INV127) / k)
    total = (np.abs(codes.astype(np.float64)) * s[:, :, None]).sum(axis=0)
    return 2 * (k + 2) * 2.0 ** -24 * total + ref.FLT_MIN


@pytest.mark.parametrize("k", PODS)
@pytest.mark.parametrize("case", CASES)
def test_wire_codes_and_absmax_bitwise_equal_reference(runs, k, case):
    _inputs_, reference, port = runs
    for rank in range(k):
        assert _same(port[k][rank][f"{case}.codes"], reference[f"{k}.{case}.codes"]), rank
        assert _same(port[k][rank][f"{case}.absmax"], reference[f"{k}.{case}.absmax"]), rank


@pytest.mark.parametrize("case", CASES)
def test_four_pod_mean_bitwise_equals_reference(runs, case):
    _inputs_, reference, port = runs
    for rank in range(4):
        assert _same(port[4][rank][f"{case}.int8"], reference[f"4.{case}.int8"][rank]), rank


@pytest.mark.parametrize("case", CASES)
def test_eight_pod_mean_within_the_stated_bound_of_reference(runs, case):
    _inputs_, reference, port = runs
    codes = port[8][0][f"{case}.codes"]
    absmax = port[8][0][f"{case}.absmax"]
    n = port[8][0][f"{case}.int8"].size
    tol = _tolerance(codes, absmax).reshape(-1)[:n]
    for rank in range(8):
        got = port[8][rank][f"{case}.int8"].astype(np.float64)
        want = reference[f"8.{case}.int8"][rank].astype(np.float64)
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= tol), (rank, float(np.max(np.abs(got - want) / tol)))


@pytest.mark.parametrize("k", PODS)
def test_ranks_agree_bitwise(runs, k):
    _inputs_, _reference, port = runs
    for rank in range(1, k):
        for key, value in port[k][0].items():
            assert _same(port[k][rank][key], value), (rank, key)
