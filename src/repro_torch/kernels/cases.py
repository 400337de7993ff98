"""Edge cases every implementation of the quantization ops must agree on.

The CPU tests feed them to the JAX reference and to the port's plain
versions; ``chip_smoke.py`` feeds them to the CUDA kernels and the plain
versions on the card. Inputs are made with numpy from a fixed seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.ref import BLOCK4, BLOCK8, codebook

#: FedAvg weights the fold cases run with (sample counts and a fraction)
FOLD_WEIGHTS = (1.0, 8.0, 0.37)


def blockwise8_cases(seed: int = 1234) -> dict[str, np.ndarray]:
    """Named flat fp32 inputs: a ragged length, an all-zero block, -0.0
    (a whole block and scattered), magnitudes from 1e-3 to 1e3, and
    subnormals (see :func:`subnormal_blocks`)."""
    rng = np.random.default_rng(seed)
    cases: dict[str, np.ndarray] = {}
    cases["ragged_6322"] = (rng.standard_normal(6322) * 3.0).astype(np.float32)
    z = rng.standard_normal(3 * BLOCK8).astype(np.float32)
    z[BLOCK8:2 * BLOCK8] = 0.0
    cases["zero_block"] = z
    nz = rng.standard_normal(2 * BLOCK8).astype(np.float32)
    nz[:BLOCK8] = -0.0
    nz[BLOCK8::7] = -0.0
    cases["neg_zero"] = nz
    for e in (-3, -1, 1, 3):
        cases[f"scale_1e{e}"] = (
            rng.standard_normal(2 * BLOCK8 + 17) * 10.0 ** e).astype(np.float32)
    cases["subnormal"] = subnormal_blocks(BLOCK8, rng)
    return cases


def subnormal_blocks(block: int, rng: np.random.Generator) -> np.ndarray:
    """Blocks that tell flushed subnormals (the reference) from kept ones:
    all subnormal; subnormals scattered in a normal block; an absmax of
    4e-37 (subnormal dequantized values); an absmax of 1e-37, whose
    blockwise8 scale 127/absmax overflows to inf; an absmax of 1e38, whose
    4-bit inverse is subnormal; and an absmax of 1e30 with elements of
    1e-10, whose normalised values are subnormal."""
    g = rng.standard_normal((6, block))
    out = np.empty((6, block), np.float32)
    out[0] = g[0] * 1e-39
    out[1] = g[1]
    out[1, ::3] = g[1, ::3] * 1e-40
    out[2] = g[2] / np.abs(g[2]).max() * 4e-37
    out[3] = g[3] / np.abs(g[3]).max() * 1e-37
    out[3, ::5] = 0.0
    out[4] = g[4] * 1e37
    out[4, 0] = 1e38
    out[5] = g[5] * 1e-10
    out[5, 1] = 1e30
    return out.reshape(-1)


def subnormal_accumulator(nblocks: int, seed: int = 98) -> np.ndarray:
    """A running fp32 sum with a subnormal in every third element and the
    rest near 1e-37, so a fold's inputs and results are subnormal."""
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((nblocks, BLOCK8)) * 1e-37
    acc[:, ::3] = rng.standard_normal((nblocks, BLOCK8))[:, ::3] * 1e-40
    return acc.astype(np.float32)


def fold_accumulator(nblocks: int, seed: int = 99) -> np.ndarray:
    """A running fp32 sum to fold into: (nblocks, 4096), magnitudes per
    block from 1e-3 to 1e3."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, (nblocks, 1))
    return (rng.standard_normal((nblocks, BLOCK8)) * scale).astype(np.float32)


def fourbit_cases(seed: int = 4321) -> dict[str, np.ndarray]:
    """Named flat fp32 inputs for the 4-bit ops: a ragged length, an
    all-zero block, -0.0 (a whole block and scattered), blocks whose
    normalised values sit exactly on each of the 15 midpoints of each
    codebook, one ulp either side of them, and at +-1, magnitudes from
    1e-3 to 1e3, and subnormals (see :func:`subnormal_blocks`)."""
    rng = np.random.default_rng(seed)
    cases: dict[str, np.ndarray] = {}
    cases["ragged_2391"] = (rng.standard_normal(2391) * 3.0).astype(np.float32)
    z = rng.standard_normal(5 * BLOCK4).astype(np.float32)
    z[2 * BLOCK4:3 * BLOCK4] = 0.0
    cases["zero_block"] = z
    nz = rng.standard_normal(4 * BLOCK4).astype(np.float32)
    nz[:BLOCK4] = -0.0
    nz[BLOCK4::5] = -0.0
    cases["neg_zero"] = nz
    for fmt in ("nf4", "fp4"):
        mids = codebook(fmt)[2]
        one = np.float32(1.0)
        block = np.concatenate([
            [one, -one], mids,
            np.nextafter(mids, np.float32(np.inf)), np.nextafter(mids, np.float32(-np.inf)),
            rng.uniform(-1.0, 1.0, BLOCK4 - 2 - 3 * mids.size),
        ]).astype(np.float32)
        # absmax 1 normalises exactly; so does any power of two
        cases[f"midpoints_{fmt}"] = np.concatenate(
            [block * np.float32(2.0 ** k) for k in (0, -10, 7)] + [-block])
    for e in (-3, -1, 1, 3):
        cases[f"scale_1e{e}"] = (
            rng.standard_normal(9 * BLOCK4 + 41) * 10.0 ** e).astype(np.float32)
    cases["subnormal"] = subnormal_blocks(BLOCK4, rng)
    return cases
