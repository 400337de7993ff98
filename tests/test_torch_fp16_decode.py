"""fp16 decode parity: every fp16 bit pattern decodes to the reference's
fp32 bits.

All 65,536 patterns (both zeros, subnormals, normals, both infinities,
quiet and signalling NaNs of either sign) go through the port's
``core.quantization.dequantize`` on the CPU and through the reference's.
The reference's ``astype`` of a jax fp16 array (the payload its
``quantize`` makes) keeps a NaN's sign and payload and quiets a
signalling NaN; the port widens by bit arithmetic to the same bits. Torch's
own CPU cast gave ``0x7fffffff`` for NaNs on its scalar path (tensors of
fewer than 8 elements, and the tail of longer ones), hence the short
tensors below.

A payload the reference decodes from the wire is a numpy array, whose
``astype`` does not quiet a signalling NaN: there the two differ in bit 22
of the 1,022 signalling-NaN patterns and nowhere else, which the last test
pins.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as RQ  # noqa: E402
from repro_torch.core import quantization as PQ  # noqa: E402

PATTERNS = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
F32 = np.dtype(np.float32)


def _reference_bits(payload) -> np.ndarray:
    qt = RQ.QuantizedTensor(payload, None, "fp16", (payload.shape[0],), F32)
    return np.asarray(RQ.dequantize(qt)).view(np.uint32)


def _port_bits(payload: np.ndarray) -> np.ndarray:
    qt = PQ.QuantizedTensor(payload, None, "fp16", (payload.shape[0],), F32)
    out = PQ.dequantize(qt, "cpu")
    assert out.dtype == torch.float32
    return out.numpy().view(np.uint32)


def test_every_fp16_pattern_decodes_bitwise_as_the_reference():
    want = _reference_bits(jnp.asarray(PATTERNS))
    got = _port_bits(PATTERNS)
    assert np.array_equal(got, want), np.nonzero(got != want)[0][:10]
    # the probe's two NaNs, a negative quiet and a positive signalling one
    assert hex(got[0xfe00]) == "0xffc00000" and hex(got[0x7d00]) == "0x7fe00000"


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9])
def test_short_tensors_decode_bitwise_as_the_reference(n):
    """Torch's scalar path (the short tensors where its cast failed) on
    windows over all patterns."""
    want_all = _reference_bits(jnp.asarray(PATTERNS))
    for start in range(0, PATTERNS.size, 509):
        chunk = PATTERNS[start:start + n]
        assert np.array_equal(_port_bits(chunk), want_all[start:start + n]), start


def test_widen_fp16_is_what_the_decode_uses_and_keeps_fp16_targets():
    want = _reference_bits(jnp.asarray(PATTERNS)).view(np.int32).copy()
    got = PQ.widen_fp16(torch.from_numpy(PATTERNS.copy()))
    assert torch.equal(got.view(torch.int32), torch.from_numpy(want))
    qt = PQ.QuantizedTensor(PATTERNS, None, "fp16", (PATTERNS.size,), np.dtype(np.float16))
    out = PQ.dequantize(qt, "cpu")
    assert out.dtype == torch.float16
    assert np.array_equal(out.numpy().view(np.uint16), PATTERNS.view(np.uint16))


def test_numpy_payload_differs_only_in_the_quiet_bit_of_signalling_nans():
    want = _reference_bits(PATTERNS)
    got = _port_bits(PATTERNS)
    h = PATTERNS.view(np.uint16)
    signalling = ((h & 0x7c00) == 0x7c00) & ((h & 0x3ff) != 0) & ((h & 0x200) == 0)
    assert int(signalling.sum()) == 1022
    assert np.array_equal(got[~signalling], want[~signalling])
    assert np.all((got ^ want)[signalling] == 1 << 22)
