"""Edge cases every implementation of the blockwise-int8 ops must agree on.

The CPU tests feed them to the JAX reference and to the port's plain
versions; ``chip_smoke.py`` feeds them to the CUDA kernels and the plain
versions on the card. Inputs are made with numpy from a fixed seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.ref import BLOCK8

#: FedAvg weights the fold cases run with (sample counts and a fraction)
FOLD_WEIGHTS = (1.0, 8.0, 0.37)


def blockwise8_cases(seed: int = 1234) -> dict[str, np.ndarray]:
    """Named flat fp32 inputs: a ragged length, an all-zero block, -0.0
    (a whole block and scattered), and magnitudes from 1e-3 to 1e3."""
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
    return cases


def fold_accumulator(nblocks: int, seed: int = 99) -> np.ndarray:
    """A running fp32 sum to fold into: (nblocks, 4096), magnitudes per
    block from 1e-3 to 1e3."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, (nblocks, 1))
    return (rng.standard_normal((nblocks, BLOCK8)) * scale).astype(np.float32)
