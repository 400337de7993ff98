"""Port parity, kernel level: the port's blockwise8 quantize, dequantize
and streaming fold against the JAX package's ``ref`` backend.

On the CPU the port's wrappers run their plain PyTorch versions; these
must give the reference's bits exactly — codes, absmax, dequantized
values and folded sums (the plain fold reproduces the reference's fused
multiply-add exactly, so no ulp allowance is needed). The CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` (marker ``cuda``) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    FOLD_WEIGHTS,
    blockwise8_cases,
    fold_accumulator,
)

CASES = blockwise8_cases()


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _reference_quantize(x: np.ndarray):
    with ref_ops.backend("ref"):
        q, am = ref_ops.quantize_blockwise8(jnp.asarray(x))
    return np.array(q), np.array(am)   # writable copies for torch.from_numpy


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_bitwise_equals_reference(name):
    x = CASES[name]
    q_ref, am_ref = _reference_quantize(x)
    q, am = ops.quantize_blockwise8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(_bits(am.numpy()), _bits(am_ref))


@pytest.mark.parametrize("name", sorted(CASES))
def test_dequantize_bitwise_equals_reference(name):
    x = CASES[name]
    q_ref, am_ref = _reference_quantize(x)
    with ref_ops.backend("ref"):
        out_ref = ref_ops.dequantize_blockwise8(jnp.asarray(q_ref), jnp.asarray(am_ref),
                                                x.shape, np.float32)
    out = ops.dequantize_blockwise8(torch.from_numpy(q_ref), torch.from_numpy(am_ref),
                                    x.shape, torch.float32)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(out_ref))


@pytest.mark.parametrize("fresh", [False, True], ids=["into_acc", "acc_none"])
@pytest.mark.parametrize("weight", FOLD_WEIGHTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_fold_bitwise_equals_reference(name, weight, fresh):
    q_ref, am_ref = _reference_quantize(CASES[name])
    acc0 = None if fresh else fold_accumulator(q_ref.shape[0])
    with ref_ops.backend("ref"):
        out_ref = ref_ops.dequant_accumulate8_into(
            None if fresh else jnp.asarray(acc0.copy()),
            jnp.asarray(q_ref), jnp.asarray(am_ref), weight)
    acc = None if fresh else torch.from_numpy(acc0.copy())
    out = ops.dequant_accumulate8_into(acc, torch.from_numpy(q_ref),
                                       torch.from_numpy(am_ref), weight)
    if acc is not None:
        assert out is acc, "the fold must update the caller's accumulator in place"
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(out_ref))


def test_plain_fold_reproduces_fma_not_unfused_arithmetic():
    """The reference's fold rounds once (an FMA); the unfused
    ``acc + q * s`` differs somewhere on these inputs, so bitwise equality
    above is a real check of the single rounding."""
    q_ref, am_ref = _reference_quantize(CASES["scale_1e3"])
    acc0 = fold_accumulator(q_ref.shape[0])
    s = torch.from_numpy(am_ref) * float(np.float32(ref.INV127) * np.float32(0.37))
    unfused = torch.from_numpy(acc0) + torch.from_numpy(q_ref).float() * s[:, None]
    fused = ref.dequant_accumulate8_into(torch.from_numpy(acc0.copy()),
                                         torch.from_numpy(q_ref),
                                         torch.from_numpy(am_ref), 0.37)
    assert not torch.equal(fused, unfused)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """Counters stay 0 on the CPU and the plain versions are what run."""
    calls = []
    for fn in ("quantize_blockwise8", "dequantize_blockwise8", "dequant_accumulate8_into"):
        orig = getattr(ref, fn)
        monkeypatch.setattr(ref, fn, lambda *a, _o=orig, _n=fn, **k: (calls.append(_n), _o(*a, **k))[1])
    ops.reset_launch_counts()
    x = torch.from_numpy(CASES["ragged_6322"])
    q, am = ops.quantize_blockwise8(x)
    ops.dequantize_blockwise8(q, am, x.shape)
    ops.dequant_accumulate8_into(None, q, am, 2.0)
    assert sorted(calls) == ["dequant_accumulate8_into", "dequantize_blockwise8",
                             "quantize_blockwise8"]
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_non_cpu_tensor_never_falls_back_to_the_plain_version():
    """A tensor off the CPU goes to the kernel or raises — here a meta
    tensor, which no kernel takes."""
    x = torch.empty((2, ref.BLOCK8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.quant_blockwise8.quantize_blockwise8(x)
    q = torch.empty((2, ref.BLOCK8), dtype=torch.int8, device="meta")
    am = torch.empty((2,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.quant_blockwise8.dequantize_blockwise8(q, am)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.dequant_accumulate8_into(torch.empty((2, ref.BLOCK8), device="meta"), q, am, 1.0)


def test_kernels_build_from_the_repo_source():
    """The CUDA library is compiled from the ``.cu`` file in this repo
    with the Hopper target and without fast math."""
    assert _build.SOURCE.is_file() and _build.SOURCE.suffix == ".cu"
    assert _build.SOURCE.parent.name == "csrc"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    src = _build.SOURCE.read_text()
    for entry in ("bw8_quantize", "bw8_dequantize", "bw8_fold"):
        assert f"int {entry}(" in src

