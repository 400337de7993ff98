"""Port parity, kernel level: the K-way dequantize-and-sum (B6) against the
JAX package, on every case of ``kernels.cases.agg_cases``.

The port's plain version (the CPU side of ``ops.dequant_accumulate8``)
runs K folds of the streaming fold's arithmetic, in order, into a zeroed
sum. Held bitwise (NaN in the same places) against:

* the reference's ``ops.dequant_accumulate8`` on the ``ref`` backend,
  which runs the same K folds, at every K;
* the reference's ``kernels/ref.py::dequant_accumulate8`` (the einsum)
  under ``jit`` — as the reference's collective runs it — at K <= 4
  (the collective at 2 pods is K = 2), at 8 and at 300 blocks. XLA then
  rewrites ``absmax / 127 * w`` as ``absmax * (f32(1/127) * w)`` and
  contracts over K as a chain of FMAs.

Held to a tolerance against the forms that round elsewhere: the einsum
evaluated eagerly (a true division by 127), the einsum under ``jit`` at
K > 4 (XLA contracts in another order) and the reference's Pallas kernel
in interpret mode. Each of two such forms is within (K + 2) roundings of
the exact sum — two in forming the scale ``s_k``, one per term of the
sum, each at most 2**-24 of ``S = sum_k |q_k| * s_k`` — so they differ
by at most ``2 * (K + 2) * 2**-24 * S`` (:func:`tolerance`); readings
here: at most 6.5 units of ``2**-24 * S`` (K = 8), 3.7 at K = 2.

The CUDA kernel is held bitwise against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro_torch.kernels import fused_dequant_agg, ops, ref  # noqa: E402
from repro_torch.kernels.cases import agg_cases  # noqa: E402

CASES = agg_cases()
_JIT_EINSUM = jax.jit(ref_kernels.dequant_accumulate8)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _assert_same(got, want) -> None:
    """Bitwise equal, NaN in the same places (a NaN's payload not compared)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def tolerance(qs: np.ndarray, absmaxes: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Per element: ``2 * (K + 2) * 2**-24 * sum_k |q_k| * s_k`` (exact
    scales, in float64), plus the smallest normal float32 for a result
    that one form flushes to zero and the other does not."""
    k = qs.shape[0]
    s = absmaxes.astype(np.float64) * (np.float64(ref.INV127) * weights.astype(np.float64))[:, None]
    with np.errstate(invalid="ignore"):   # 0 * inf where a result is NaN anyway
        total = (np.abs(qs.astype(np.float64)) * s[:, :, None]).sum(axis=0)
    return 2 * (k + 2) * 2.0 ** -24 * total + ref.FLT_MIN


def _assert_within(got, want, tol) -> None:
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    assert (err <= tol[fin]).all(), float((err / tol[fin]).max())


def _port(qs, absmaxes, weights) -> np.ndarray:
    return ops.dequant_accumulate8(torch.from_numpy(qs), torch.from_numpy(absmaxes),
                                   torch.from_numpy(weights)).numpy()


def _reference(fn, qs, absmaxes, weights) -> np.ndarray:
    return np.asarray(fn(jnp.asarray(qs), jnp.asarray(absmaxes), jnp.asarray(weights)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_bitwise_equals_reference_folds(name):
    qs, am, w = CASES[name]
    with ref_ops.backend("ref"):
        want = _reference(ref_ops.dequant_accumulate8, qs, am, w)
    _assert_same(_port(qs, am, w), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_against_the_jitted_einsum(name):
    """Bitwise where the collective's path lies (K <= 4), within the
    stated tolerance beyond it."""
    qs, am, w = CASES[name]
    got, want = _port(qs, am, w), _reference(_JIT_EINSUM, qs, am, w)
    if qs.shape[0] <= 4:
        _assert_same(got, want)
    else:
        _assert_within(got, want, tolerance(qs, am, w))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_within_tolerance_of_the_eager_einsum(name):
    qs, am, w = CASES[name]
    _assert_within(_port(qs, am, w), _reference(ref_kernels.dequant_accumulate8, qs, am, w),
                   tolerance(qs, am, w))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_within_tolerance_of_the_pallas_kernel(name):
    qs, am, w = CASES[name]
    with ref_ops.backend("pallas_interpret"):
        want = _reference(ref_ops.dequant_accumulate8, qs, am, w)
    _assert_within(_port(qs, am, w), want, tolerance(qs, am, w))


@pytest.mark.parametrize("pods", [2, 3])
def test_collective_shape_bitwise_equals_the_jitted_einsum(pods):
    """300 blocks of the collective's mean (weights 1/P), as the reference's
    collective contracts them under jit."""
    rng = np.random.default_rng(pods)
    qs = rng.integers(-127, 128, (pods, 300, ref.BLOCK8)).astype(np.int8)
    am = (10.0 ** rng.uniform(-3, 3, (pods, 300))).astype(np.float32)
    w = np.full(pods, 1.0 / pods, np.float32)
    got = _port(qs, am, w)
    _assert_same(got, _reference(_JIT_EINSUM, qs, am, w))
    _assert_within(got, _reference(ref_kernels.dequant_accumulate8, qs, am, w),
                   tolerance(qs, am, w))


def test_cpu_dispatch_counts_no_launch_and_takes_sequences():
    qs, am, w = CASES["weights_k3"]
    ops.reset_launch_counts()
    a = ops.dequant_accumulate8(torch.from_numpy(qs), torch.from_numpy(am), list(map(float, w)))
    b = ref.dequant_accumulate8(torch.from_numpy(qs), torch.from_numpy(am), torch.from_numpy(w))
    assert a.dtype == torch.float32 and tuple(a.shape) == qs.shape[1:]
    assert torch.equal(a, b)
    assert ops.launch_counts()["dequant_accumulate8"] == 0


def test_plain_version_is_k_folds_in_order():
    """The plain version is the streaming fold applied pod after pod."""
    qs, am, w = (torch.from_numpy(a) for a in CASES["weights_k8"])
    acc = torch.zeros(qs.shape[1:], dtype=torch.float32)
    for k in range(qs.shape[0]):
        ref.dequant_accumulate8_into(acc, qs[k], am[k], float(w[k]))
    assert torch.equal(ref.dequant_accumulate8(qs, am, w), acc)


@pytest.mark.parametrize("bad", ["ndim", "pods", "blocks"])
def test_cuda_wrapper_checks_shapes_before_launching(bad):
    """Off the CPU, mismatched shapes raise before anything is launched
    (meta tensors stand in for CUDA ones, which this host lacks)."""
    qs = torch.zeros((2, 3, ref.BLOCK8), dtype=torch.int8, device="meta")
    am = torch.zeros((2, 3), dtype=torch.float32, device="meta")
    w = torch.zeros((2,), dtype=torch.float32, device="meta")
    if bad == "ndim":
        qs = qs[0]
    elif bad == "pods":
        w = torch.zeros((3,), dtype=torch.float32, device="meta")
    else:
        am = torch.zeros((2, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="disagree"):
        fused_dequant_agg.dequant_accumulate8(qs, am, w)
