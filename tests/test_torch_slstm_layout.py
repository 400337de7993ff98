"""The sLSTM scan kernel's cluster layout, as its wrapper picks it from the
head dim (``repro_torch.kernels.slstm_scan.cluster_layout``; the CUDA
source recomputes it in ``layout_for`` and refuses any other).

Every head dim the wrapper takes must give a layout a block can hold on an
H100 (at most 232,448 bytes of shared memory) and a cluster of 4 (one CTA
per gate) or 8 (each gate over 2 CTAs), both portable cluster sizes; and
enough threads for the gate math, which runs one unit a thread.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.slstm_scan import (  # noqa: E402
    MAX_HEAD_DIM,
    SLICES,
    SMEM_LIMIT,
    cluster_layout,
)


def test_every_head_dim_fits_a_block_and_a_portable_cluster():
    assert SMEM_LIMIT == 232_448
    for hd in range(1, MAX_HEAD_DIM + 1):
        layout = cluster_layout(hd)
        assert layout.smem_bytes <= SMEM_LIMIT, (hd, layout)
        assert layout.cluster in (4, 8), (hd, layout)
        assert layout.cluster == 4 * layout.split, (hd, layout)
        # whole warps of 8 column pairs x SLICES slices, at least one thread
        # per unit of the gate math, and within the kernel's launch bounds
        assert layout.threads % (8 * SLICES) == 0, (hd, layout)
        assert hd <= layout.threads <= 512, (hd, layout)


def test_one_gate_a_cta_wherever_it_fits():
    """hd 192 (xlstm-125m): each CTA holds one gate's 147,456 bytes of r,
    and a cluster of 8 only where one gate's slice cannot fit (hd > 224)."""
    full = cluster_layout(192)
    assert (full.cluster, full.threads) == (4, 384)
    assert full.smem_bytes == 4 * (192 * 192 + 2 * 4 * 192 + 192) == 154_368
    assert cluster_layout(224).cluster == 4
    assert [hd for hd in range(1, MAX_HEAD_DIM + 1)
            if cluster_layout(hd).cluster == 8] == list(range(225, MAX_HEAD_DIM + 1))
    assert cluster_layout(256) == (8, 2, 256, 140_288)


@pytest.mark.parametrize("hd", [0, MAX_HEAD_DIM + 1])
def test_head_dims_outside_the_kernel_raise(hd):
    with pytest.raises(ValueError, match="head dim"):
        cluster_layout(hd)
