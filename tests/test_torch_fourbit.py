"""Port parity, 4-bit kernels: the port's fp4 / nf4 quantize and
dequantize against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these
must give the reference's bits exactly — packed codes, absmax and
dequantized values — against the reference's ``ref`` backend on every
edge case of ``kernels/cases.py::fourbit_cases``, and against its Pallas
kernel run in interpret mode on a case of 320 blocks. The CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` (marker ``cuda``) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.kernels import ops, quant_nf4, ref  # noqa: E402
from repro_torch.kernels.cases import fourbit_cases  # noqa: E402

CASES = fourbit_cases()
FMTS = ("nf4", "fp4")


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


def _reference_quantize(x: np.ndarray, fmt: str, backend: str = "ref"):
    with ref_ops.backend(backend):
        p, am = ref_ops.quantize_4bit(jnp.asarray(x), fmt)
    return np.array(p), np.array(am)   # writable copies for torch.from_numpy


def test_codebooks_are_the_references_bit_for_bit():
    for fmt, theirs in (("fp4", ref_ref.FP4_CODE), ("nf4", ref_ref.NF4_CODE)):
        code, perm, mids = ref.codebook(fmt)
        assert code.dtype == np.float32 and code.tobytes() == theirs.tobytes()
        sorted_theirs, perm_theirs = ref_ref._sorted_code_and_perm(theirs)
        np.testing.assert_array_equal(perm, perm_theirs)
        assert mids.dtype == np.float32 and mids.shape == (15,)
        want = ((sorted_theirs[1:] + sorted_theirs[:-1]) / 2.0).astype(np.float32)
        assert mids.tobytes() == want.tobytes()
        assert (np.diff(mids) > 0).all()
    # the stable sort ranks FP4's 0.0 (index 0) before its -0.0 (index 8)
    perm = list(ref.codebook("fp4")[1])
    assert perm.index(0) < perm.index(8)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_4bit_bitwise_equals_reference(name, fmt):
    x = CASES[name]
    p_ref, am_ref = _reference_quantize(x, fmt)
    p, am = ops.quantize_4bit(torch.from_numpy(x), fmt)
    assert p.dtype == torch.uint8 and p.shape == p_ref.shape
    np.testing.assert_array_equal(p.numpy(), p_ref)
    _assert_same(am.numpy(), am_ref)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_dequantize_4bit_bitwise_equals_reference(name, fmt):
    x = CASES[name]
    p_ref, am_ref = _reference_quantize(x, fmt)
    with ref_ops.backend("ref"):
        out_ref = ref_ops.dequantize_4bit(jnp.asarray(p_ref), jnp.asarray(am_ref), fmt,
                                          x.shape, np.float32)
    out = ops.dequantize_4bit(torch.from_numpy(p_ref), torch.from_numpy(am_ref), fmt,
                              x.shape, torch.float32)
    assert out.shape == x.shape
    _assert_same(out.numpy(), out_ref)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_4bit_bitwise_equals_pallas_interpret(fmt):
    """The reference's Pallas kernel itself (interpret mode), on 320
    blocks with an all-zero block, -0.0 and exact midpoints mixed in."""
    x = np.concatenate([CASES["scale_1e1"][: 300 * ref.BLOCK4 // 10],
                        CASES["zero_block"], CASES["neg_zero"], CASES[f"midpoints_{fmt}"]])
    x = np.resize(x, 320 * ref.BLOCK4).astype(np.float32)
    p_ref, am_ref = _reference_quantize(x, fmt, backend="pallas_interpret")
    p, am = ops.quantize_4bit(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(p.numpy(), p_ref)
    _assert_same(am.numpy(), am_ref)


@pytest.mark.parametrize("fmt", FMTS)
def test_plain_versions_keep_nan_and_inf_in_absmax(fmt):
    """The ``nan_inf`` case is a real check: a block holding NaN has absmax
    NaN (so inv 0), one holding an infinity absmax inf, and the finite
    block after them is untouched — what the reference gives
    (``test_quantize_4bit_bitwise_equals_reference[nan_inf]``)."""
    x2d = torch.from_numpy(CASES["nan_inf"]).reshape(-1, ref.BLOCK4)
    p, am = ref.quantize_4bit(x2d, fmt)
    assert torch.isnan(am[[0, 3]]).all() and torch.isinf(am[[1, 2]]).all()
    assert am[4] == x2d[4].abs().max()
    d = ref.dequantize_4bit(p, am, fmt)
    assert torch.isnan(d[[0, 3]]).all() and torch.isfinite(d[4]).all()


@pytest.mark.parametrize("fmt", FMTS)
def test_midpoint_cases_exercise_strict_compares_and_nibble_order(fmt):
    """Bitwise equality above is a real check of the compare and the
    packing: a non-strict compare, or the other nibble order, gives other
    bytes on the midpoint case."""
    x2d = torch.from_numpy(CASES[f"midpoints_{fmt}"]).reshape(-1, ref.BLOCK4)
    p, am = ref.quantize_4bit(x2d, fmt)
    _code, perm, mids = ref.codebook(fmt)
    xn = x2d * (torch.ones_like(am) / am)[:, None]
    rank_ge = sum((xn >= float(m)).to(torch.int64) for m in mids)
    idx_ge = torch.from_numpy(perm).long()[rank_ge]
    assert not torch.equal(((idx_ge[:, 0::2] << 4) | idx_ge[:, 1::2]).to(torch.uint8), p)
    swapped = (p >> 4) | ((p & 0xF) << 4)
    assert not torch.equal(swapped, p)
    d = ref.dequantize_4bit(p, am, fmt)
    d_swapped = ref.dequantize_4bit(swapped, am, fmt)
    assert not torch.equal(d, d_swapped)


def test_fp4_negative_zero_codes_survive_dequantize():
    """FP4's -0.0 entry (index 8) dequantizes to -0.0, sign bit and all."""
    packed = torch.tensor([[0x88] * (ref.BLOCK4 // 2)], dtype=torch.uint8)
    out = ref.dequantize_4bit(packed, torch.tensor([2.5]), "fp4")
    assert (out == 0).all() and torch.signbit(out).all()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    calls = []
    for fn in ("quantize_4bit", "dequantize_4bit"):
        orig = getattr(ref, fn)
        monkeypatch.setattr(ref, fn, lambda *a, _o=orig, _n=fn, **k:
                            (calls.append(_n), _o(*a, **k))[1])
    ops.reset_launch_counts()
    x = torch.from_numpy(CASES["ragged_2391"])
    p, am = ops.quantize_4bit(x, "nf4")
    ops.dequantize_4bit(p, am, "nf4", x.shape)
    assert calls == ["quantize_4bit", "dequantize_4bit"]
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert {"quantize_4bit", "dequantize_4bit"} <= set(ops.KERNELS)


def test_non_cpu_tensor_never_falls_back_to_the_plain_version():
    x = torch.empty((2, ref.BLOCK4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant_nf4.quantize_4bit(x, "nf4")
    p = torch.empty((2, ref.BLOCK4 // 2), dtype=torch.uint8, device="meta")
    am = torch.empty((2,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant_nf4.dequantize_4bit(p, am, "fp4")
    with pytest.raises(ValueError, match="unknown 4-bit format"):
        quant_nf4.quantize_4bit(x, "int4")


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_batch_is_one_fused_group_per_format(fmt, monkeypatch):
    """``quantize_batch`` runs one 4-bit quantize over the message's whole
    format group, and each tensor's slice of it equals the per-tensor
    quantize (and the reference's); the other format's tensors go to
    their own group."""
    rng = np.random.default_rng(3)
    items = {"a": (rng.standard_normal((7, 33)) * 2).astype(np.float32),
             "b": rng.standard_normal(64 * 5).astype(np.float32),
             "c": rng.standard_normal((3, 5000)).astype(np.float32),
             "n": rng.standard_normal(11).astype(np.float32)}
    fmt_for = {"a": fmt, "b": fmt, "c": "blockwise8", "n": "fp16"}
    calls = []
    orig = ref.quantize_4bit
    monkeypatch.setattr(ref, "quantize_4bit",
                        lambda x2d, f: (calls.append((x2d.shape, f)), orig(x2d, f))[1])
    out = Q.quantize_batch(items, fmt_for, "cpu")
    blocks = sum(-(-items[k].size // ref.BLOCK4) for k in ("a", "b"))
    assert calls == [((blocks, ref.BLOCK4), fmt)]
    assert [out[k].fmt for k in items] == [fmt, fmt, "blockwise8", "fp16"]
    for name in ("a", "b"):
        qt = out[name]
        assert isinstance(qt.payload, np.ndarray) and qt.payload.dtype == np.uint8
        p_ref, am_ref = _reference_quantize(items[name], fmt)
        np.testing.assert_array_equal(qt.payload, p_ref)
        _assert_same(qt.absmax, am_ref)
        back = Q.dequantize(qt, "cpu")
        assert back.shape == items[name].shape and back.dtype == torch.float32
