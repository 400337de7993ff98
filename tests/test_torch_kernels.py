"""Port parity, kernel level: the port's blockwise8 quantize, dequantize
and streaming fold against the JAX package's ``ref`` backend.

On the CPU the port's wrappers run their plain PyTorch versions; these
must give the reference's bits exactly — codes, absmax, dequantized
values and folded sums (the plain fold reproduces the reference's fused
multiply-add exactly, so no ulp allowance is needed), subnormal inputs
and results included (the reference flushes them to zero). The CUDA kernels
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
    one_block_folds,
    subnormal_accumulator,
)

CASES = blockwise8_cases()


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _assert_same(got, want) -> None:
    """Bitwise equal, with NaN in the same places (``equal_nan``): a NaN's
    sign and payload are not compared — the reference's ``0 * inf`` gives
    x86's negative default NaN where PyTorch's may give a positive one."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


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
    _assert_same(am.numpy(), am_ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dequantize_bitwise_equals_reference(name):
    x = CASES[name]
    q_ref, am_ref = _reference_quantize(x)
    with ref_ops.backend("ref"):
        out_ref = ref_ops.dequantize_blockwise8(jnp.asarray(q_ref), jnp.asarray(am_ref),
                                                x.shape, np.float32)
    out = ops.dequantize_blockwise8(torch.from_numpy(q_ref), torch.from_numpy(am_ref),
                                    x.shape, torch.float32)
    _assert_same(out.numpy(), out_ref)


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
    _assert_same(out.numpy(), out_ref)


@pytest.mark.parametrize("weight", FOLD_WEIGHTS)
def test_fold_into_subnormal_accumulator_bitwise_equals_reference(weight):
    """The reference flushes subnormals on the fold's inputs and result;
    so must the port."""
    q_ref, am_ref = _reference_quantize(CASES["subnormal"])
    acc0 = subnormal_accumulator(q_ref.shape[0])
    with ref_ops.backend("ref"):
        out_ref = ref_ops.dequant_accumulate8_into(
            jnp.asarray(acc0.copy()), jnp.asarray(q_ref), jnp.asarray(am_ref), weight)
    out = ops.dequant_accumulate8_into(torch.from_numpy(acc0.copy()), torch.from_numpy(q_ref),
                                       torch.from_numpy(am_ref), weight)
    _assert_same(out.numpy(), out_ref)


def test_plain_versions_flush_subnormals():
    """The subnormal case is a real check: without the flush, the plain
    versions' codes, absmax and dequantized values differ from what they
    give."""
    x2d = torch.from_numpy(CASES["subnormal"]).reshape(-1, ref.BLOCK8)
    q, am = ref.quantize_blockwise8(x2d)
    assert am[0] == 0 and (q[0] == 0).all()          # an all-subnormal block
    assert float(x2d.abs()[0].max()) > 0
    assert (q[3][x2d[3] == 0] == 0).all()             # 0 * inf scale -> 0
    d = ref.dequantize_blockwise8(q, am)
    kept = q[2].float() * (am[2] * ref.INV127)
    assert (kept.abs() < ref.FLT_MIN).any() and (kept != 0).any()
    assert bool((d[2].abs() >= ref.FLT_MIN).logical_or(d[2] == 0).all())


def test_plain_versions_keep_nan_and_inf_in_absmax():
    """The ``nan_inf`` case is a real check: a block holding NaN has absmax
    NaN and all-zero codes, one holding an infinity absmax inf, and the
    finite block after them is untouched — what the reference gives
    (``test_quantize_bitwise_equals_reference[nan_inf]``)."""
    x2d = torch.from_numpy(CASES["nan_inf"]).reshape(-1, ref.BLOCK8)
    q, am = ref.quantize_blockwise8(x2d)
    assert torch.isnan(am[[0, 3]]).all() and torch.isinf(am[[1, 2]]).all()
    assert (q[:4] == 0).all() and am[4] == x2d[4].abs().max()
    d = ref.dequantize_blockwise8(q, am)
    assert torch.isnan(d[:4]).all() and torch.isfinite(d[4]).all()


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
    """The CUDA library is compiled from every ``.cu`` file under
    ``csrc/`` in this repo with the Hopper target and without fast math,
    and each C entry point the wrappers bind is defined in one of them."""
    names = [p.name for p in _build.SOURCES]
    assert names == ["blockwise8.cu", "flash_attention.cu", "fourbit.cu",
                     "slstm_scan.cu"], names
    assert all(p.parent.name == "csrc" and p.is_file() for p in _build.SOURCES)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags and "-ftz" not in flags
    src = "".join(p.read_text() for p in _build.SOURCES)
    assert set(_build._SIGNATURES) == {"bw8_quantize", "bw8_dequantize", "bw8_fold",
                                       "bw8_agg", "fb4_quantize", "fb4_dequantize",
                                       "flash_attention_fwd", "flash_attention_occupancy",
                                       "slstm_scan_fwd"}
    for entry in _build._SIGNATURES:
        assert f"int {entry}(" in src, entry



@pytest.mark.parametrize("weight", FOLD_WEIGHTS + (3.0, 1 / 3))
def test_one_block_folds_bitwise_equal_reference(weight):
    """A one-block item (a norm scale's 256 values) folds with the scale
    ``(absmax * f32(1/127)) * w``, not ``absmax * (f32(1/127) * w)``: XLA
    reassociates the constant with the weight only at two blocks or more
    (``kernels.ref.fold_scale``). 64 items, into an accumulator and fresh;
    the K-way sum (K folds) at one block too."""
    folds = one_block_folds()
    acc0 = fold_accumulator(1)
    with ref_ops.backend("ref"):
        for q, am in folds:
            for fresh in (True, False):
                want = ref_ops.dequant_accumulate8_into(
                    None if fresh else jnp.asarray(acc0.copy()), jnp.asarray(q),
                    jnp.asarray(am), weight)
                got = ops.dequant_accumulate8_into(
                    torch.zeros((1, ref.BLOCK8)) if fresh else torch.from_numpy(acc0.copy()),
                    torch.from_numpy(q), torch.from_numpy(am), weight)
                _assert_same(got.numpy(), want)
        qs = np.stack([q for q, _ in folds[:3]])
        ams = np.stack([am for _, am in folds[:3]])
        ws = np.array([weight, 0.37, 3.0], np.float32)
        want = ref_ops.dequant_accumulate8(jnp.asarray(qs), jnp.asarray(ams), jnp.asarray(ws))
    got = ops.dequant_accumulate8(torch.from_numpy(qs), torch.from_numpy(ams),
                                  torch.from_numpy(ws))
    _assert_same(got.numpy(), want)


def test_one_block_fold_scale_is_a_real_check():
    """The two orders of the scale differ on these inputs, so the test
    above tells them apart."""
    differ = 0
    for _q, am in one_block_folds():
        a = np.float32(np.float32(am[0]) * np.float32(ref.INV127)) * np.float32(1 / 3)
        b = np.float32(am[0]) * np.float32(np.float32(ref.INV127) * np.float32(1 / 3))
        differ += int(np.float32(a) != np.float32(b))
    assert differ > 0
