"""The flash-attention kernels' layouts, as the wrapper gives them
(``repro_torch.kernels.flash_attention.layout``; the CUDA source
recomputes them in ``WideLayout`` / ``Layout`` and ``config`` and refuses
any other).

Every layout must fit a block's shared memory on an H100 (at most
232,448 bytes), and the wide kernel (hd 96 and 256) must ask for at least
8 warps on each SM in both input types, so that a layout over budget in
bytes or threads fails here and not first on the card. Whether the card
really holds 8 warps an SM also depends on the registers a thread, which
only the build knows: ``tests/test_torch_cuda.py``'s
``test_wide_flash_kernel_holds_8_warps_an_sm_without_spills_on_the_card``
and ``chip_smoke.check_wide_occupancy`` check that on the card.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    DTYPES,
    HEAD_DIMS,
    QUERY_TILE,
    SMEM_LIMIT,
    WIDE_HEAD_DIMS,
    layout,
)

WIDE = [(hd, dt) for hd in WIDE_HEAD_DIMS for dt in DTYPES]


@pytest.mark.parametrize("hd,dtype", WIDE, ids=[f"hd{hd}-{str(dt).replace('torch.', '')}"
                                                for hd, dt in WIDE])
def test_the_wide_kernel_fits_a_block_with_8_warps_on_an_sm(hd, dtype):
    lay = layout(hd, dtype)
    assert SMEM_LIMIT == 232_448
    assert lay.kernel == "flash_wide_kernel"
    assert lay.smem_bytes <= SMEM_LIMIT, lay
    assert lay.warps * lay.ctas_per_sm >= 8, lay
    # a ring of at least 3 stages; whole blocks of 16 rows, each over `split` warps
    assert lay.stages >= 3, lay
    assert lay.rows * lay.split == 16 * lay.warps, lay
    assert hd % lay.split == 0 and (hd // lay.split) % 8 == 0, lay
    # two halves of whole 8-key n-tiles a tile
    assert lay.keys % 16 == 0, lay


def test_the_wide_layouts_as_the_source_note_gives_them():
    """The byte counts of ``csrc/flash_attention.cu``'s note: fp32 hd 96 /
    256 104,960 / 142,592, bf16 39,936 / 117,760; a ring of 3 stages; hd
    256 pairs warps (64 rows a CTA) and takes 16-key tiles in fp32."""
    f32, b16 = torch.float32, torch.bfloat16
    assert layout(96, f32) == ("flash_wide_kernel", 8, 1, 128, 32, 3, 1, 104_960)
    assert layout(256, f32) == ("flash_wide_kernel", 8, 2, 64, 16, 3, 1, 142_592)
    assert layout(96, b16) == ("flash_wide_kernel", 8, 1, 128, 32, 3, 1, 39_936)
    assert layout(256, b16) == ("flash_wide_kernel", 8, 2, 64, 32, 3, 1, 117_760)
    # fp32 hd 256 itemised: 3 hi stages, 2 lo sets, one exchange slot a warp
    stage = 4 * 16 * ((256 + 8) + (256 + 4))
    lo = 4 * (16 * (256 // 2 + 4) + 8 * (256 + 8))
    assert 3 * stage + 2 * lo + 4 * 8 * 16 * 16 == 142_592


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_every_head_dim_fits_a_block_and_sets_the_query_tile(hd):
    for dtype in DTYPES:
        lay = layout(hd, dtype)
        assert lay.smem_bytes <= SMEM_LIMIT, (hd, dtype, lay)
        assert lay.rows == QUERY_TILE[hd], (hd, dtype, lay)
        assert lay.kernel == ("flash_wide_kernel" if hd in WIDE_HEAD_DIMS
                              else "flash_fwd_kernel")


def test_the_hd_64_128_kernel_keeps_its_layout():
    """``flash_fwd_kernel``'s bytes as its source note gives them."""
    f32, b16 = torch.float32, torch.bfloat16
    assert [layout(hd, dt).smem_bytes for hd in (64, 128) for dt in (f32, b16)] == [
        179_200, 120_832, 171_520, 117_760]
    assert {layout(hd, dt).rows for hd in (64, 128) for dt in (f32, b16)} == {128}


@pytest.mark.parametrize("hd,dtype", [(80, torch.float32), (96, torch.float16)])
def test_layouts_outside_the_kernel_raise(hd, dtype):
    with pytest.raises(ValueError, match="built for|takes"):
        layout(hd, dtype)
