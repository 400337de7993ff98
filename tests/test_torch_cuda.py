"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

Each kernel against its plain PyTorch version on the card, on the edge
cases every implementation must agree on: quantize and dequantize
bitwise, the fold bitwise (both round once: the kernel's ``fmaf`` and the
plain version's float64 round-to-odd sum). Imports torch and the port
only, so it runs on the card machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere the tests skip.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    FOLD_WEIGHTS,
    blockwise8_cases,
    fold_accumulator,
)
from repro_torch.kernels.quant_blockwise8 import (  # noqa: E402
    dequantize_blockwise8,
    quantize_blockwise8,
)

CASES = blockwise8_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_bitwise_equal_plain_versions_on_the_card(cuda, name):
    x2d = ops.pad_to_blocks(torch.from_numpy(CASES[name]).to(cuda))
    before = ops.launch_counts()
    q, am = quantize_blockwise8(x2d)
    q_p, am_p = ref.quantize_blockwise8(x2d)
    assert torch.equal(q, q_p) and torch.equal(_bits(am), _bits(am_p))
    d = dequantize_blockwise8(q, am)
    assert torch.equal(_bits(d), _bits(ref.dequantize_blockwise8(q, am)))
    for w in FOLD_WEIGHTS:
        acc0 = torch.from_numpy(fold_accumulator(q.shape[0])).to(cuda)
        k = ops.dequant_accumulate8_into(acc0.clone(), q, am, w)
        p = ref.dequant_accumulate8_into(acc0.clone(), q, am, w)
        assert torch.equal(_bits(k), _bits(p)), w
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["quantize_blockwise8"] - before["quantize_blockwise8"] == 1
    assert after["dequantize_blockwise8"] - before["dequantize_blockwise8"] == 1
    assert after["dequant_accumulate8_into"] - before["dequant_accumulate8_into"] == len(FOLD_WEIGHTS)
