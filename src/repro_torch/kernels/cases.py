"""Edge cases every implementation of the kernels must agree on.

The CPU tests feed them to the JAX reference and to the port's plain
versions; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` feed them to
the CUDA kernels and the plain versions on the card. Inputs are made with
numpy from a fixed seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.ref import BLOCK4, BLOCK8, codebook

#: FedAvg weights the fold cases run with (sample counts and a fraction)
FOLD_WEIGHTS = (1.0, 8.0, 0.37)


def blockwise8_cases(seed: int = 1234) -> dict[str, np.ndarray]:
    """Named flat fp32 inputs: a ragged length, an all-zero block, -0.0
    (a whole block and scattered), magnitudes from 1e-3 to 1e3,
    subnormals (see :func:`subnormal_blocks`), NaN and infinities (see
    :func:`nonfinite_blocks`) and one short block (a norm scale's 256
    values)."""
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
    cases["nan_inf"] = nonfinite_blocks(BLOCK8, rng)
    # drawn last, so the cases above keep their inputs
    cases["one_block_256"] = (rng.standard_normal(256) * 0.05).astype(np.float32)
    return cases


def agg_cases(seed: int = 2468) -> dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Named inputs of the K-way dequantize-and-sum: ``(qs, absmaxes,
    weights)`` as (K, nblocks, 4096) int8 codes in [-127, 127], (K, nblocks)
    fp32 absmax and (K,) fp32 weights. K = 1, 2, 3, 4, 8 and 16; the
    collective's mean (weights 1/K); weights that are 0 or do not sum to 1;
    a ragged block count; an all-zero block (codes 0, absmax 0) in every
    pod; subnormal absmax, weights and results; NaN and inf absmax; and
    absmax from 1e-3 to 1e3 per block."""
    rng = np.random.default_rng(seed)

    def stack(k: int, nblocks: int, weights) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        qs = rng.integers(-127, 128, (k, nblocks, BLOCK8)).astype(np.int8)
        absmaxes = (10.0 ** rng.uniform(-3, 3, (k, nblocks))).astype(np.float32)
        return qs, absmaxes, np.asarray(weights, np.float32)

    cases: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for k in (1, 2, 3, 4, 8, 16):
        cases[f"mean_k{k}"] = stack(k, 8, np.full(k, 1.0 / k))
    cases["weights_k3"] = stack(3, 8, FOLD_WEIGHTS)
    cases["weights_k8"] = stack(8, 8, rng.uniform(0.0, 4.0, 8))
    cases["zero_weights"] = stack(4, 8, (0.0, 0.5, 0.0, 2.0))
    cases["ragged_13"] = stack(2, 13, (0.5, 0.5))
    qs, am, w = stack(3, 8, (0.2, 0.3, 0.5))
    qs[:, 5] = 0
    am[:, 5] = 0.0
    cases["zero_block"] = (qs, am, w)
    # absmax subnormal (block 0), whose scale 1/127 of it is subnormal
    # (block 1), whose products are subnormal (block 2), and a subnormal
    # weight (pod 2) against an absmax of 1e30
    qs, am, _w = stack(3, 8, (0.5, 0.25, 1e-40))
    am[:, 0] = 1e-39
    am[:, 1] = 1e-37
    am[:, 2] = 4e-36
    am[2, 3] = 1e30
    cases["subnormal"] = (qs, am, np.array([0.5, 0.25, 1e-40], np.float32))
    qs, am, w = stack(2, 8, (0.5, 0.5))
    am[0, 0] = np.nan
    am[1, 1] = np.inf
    am[0, 2] = np.inf
    am[1, 2] = np.nan
    am[:, 3] = np.inf
    qs[1, 1, ::7] = 0      # 0 * inf = NaN
    cases["nan_inf"] = (qs, am, w)
    return cases


def nonfinite_blocks(block: int, rng: np.random.Generator) -> np.ndarray:
    """Normal blocks, each but the last holding non-finite values: one NaN;
    one +inf; one -inf; a negative NaN with both infinities; and a finite
    block after them. The reference's absmax is NaN for a block holding
    NaN and inf for one holding an infinity only."""
    out = rng.standard_normal((5, block)).astype(np.float32)
    out[0, 5] = np.nan
    out[1, 7] = np.inf
    out[2, 3] = -np.inf
    out[3, 1] = -np.float32(np.nan)
    out[3, 2] = np.inf
    out[3, block - 1] = -np.inf
    return out.reshape(-1)


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


def one_block_folds(n: int = 64, seed: int = 7531) -> list[tuple[np.ndarray, np.ndarray]]:
    """``n`` single-block fold inputs: (1, 4096) int8 codes in [-127, 127]
    and a (1,) fp32 absmax from 1e-3 to 1e3 each. At one block the
    reference's fold forms its scale in another order than at two or more
    (``kernels.ref.fold_scale``), which one sample may not show."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(-127, 128, (1, BLOCK8)).astype(np.int8),
             (10.0 ** rng.uniform(-3, 3, 1)).astype(np.float32)) for _ in range(n)]


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
    1e-3 to 1e3, subnormals (see :func:`subnormal_blocks`) and NaN and
    infinities (see :func:`nonfinite_blocks`)."""
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
    cases["nan_inf"] = nonfinite_blocks(BLOCK4, rng)
    return cases


#: the flash-attention cases: batch, query heads, KV heads, query and key
#: lengths, head dim, dtype, causal, window (None = no window)
ATTENTION_FIELDS = ("B", "H", "KV", "sq", "sk", "hd", "dtype", "causal", "window")
ATTENTION_CASES: dict[str, tuple] = {
    # query heads per KV head: 1, 2, 4 and 8
    "group1": (2, 4, 4, 128, 128, 64, "float32", True, None),
    "group2": (2, 4, 2, 256, 256, 64, "float32", True, None),
    "group4": (1, 8, 2, 128, 128, 64, "float32", True, None),
    "group8": (1, 8, 1, 128, 128, 64, "float32", True, None),
    "hd128": (2, 4, 2, 256, 256, 128, "float32", True, None),
    "non_causal": (1, 2, 2, 128, 128, 64, "float32", False, None),
    "window32": (1, 2, 1, 256, 256, 64, "float32", True, 32),
    "window64": (1, 2, 1, 256, 256, 64, "float32", True, 64),
    # a window narrower than a 64-row tile
    "window16": (1, 4, 2, 256, 256, 128, "float32", True, 16),
    "window_non_causal": (1, 2, 1, 192, 192, 64, "float32", False, 40),
    # Sq != Sk, as in tests/test_flash_attention.py::_qkv (prompt vs cache)
    "cross_lengths": (1, 2, 2, 64, 256, 64, "float32", False, None),
    # rows past Sk + window - 1 see no key: a uniform softmax over all Sk
    "fully_masked_rows": (1, 2, 1, 256, 64, 64, "float32", True, 32),
    # lengths that are no multiple of a tile (the plain version's and the
    # kernel's only; the reference's kernel needs whole blocks)
    "ragged": (1, 4, 2, 200, 200, 64, "float32", True, 48),
    "bf16": (1, 2, 2, 128, 128, 64, "bfloat16", True, None),
    "bf16_hd128_window": (1, 4, 1, 256, 256, 128, "bfloat16", True, 64),
    # a query length that is a multiple of 64 but not of the kernel's 128-row
    # tile, with a window that is no multiple of a 64-key tile
    "window100_sq320": (1, 4, 2, 320, 320, 64, "float32", True, 100),
    # bf16 at hd 128 without a window (its kernel keeps Q whole in registers)
    "bf16_hd128": (1, 4, 2, 256, 256, 128, "bfloat16", True, None),
    # the wide head dims: phi-3-vision's 96 (MHA) and recurrentgemma's 256
    # (MQA, a window narrower than the sequence)
    "hd96": (2, 4, 4, 256, 256, 96, "float32", True, None),
    "hd256_mqa_window": (1, 4, 1, 256, 256, 256, "float32", True, 64),
    "hd256_non_causal": (1, 2, 1, 128, 128, 256, "float32", False, None),
    "hd256_cross_lengths": (1, 2, 1, 64, 256, 256, "float32", False, None),
    "bf16_hd96": (1, 4, 4, 128, 128, 96, "bfloat16", True, None),
    "bf16_hd256": (1, 4, 1, 256, 256, 256, "bfloat16", True, 64),
    # ragged lengths at both wide head dims; at hd 256 Sq > Sk, and the rows
    # past Sk + window - 1 see no key
    "hd96_ragged": (1, 2, 1, 200, 200, 96, "float32", True, 48),
    "hd256_ragged_blind": (1, 2, 1, 136, 72, 256, "float32", True, 32),
    # six query heads a KV head at hd 128, as dbrx-132b's 48 over 8
    "group6_hd128": (1, 12, 2, 128, 128, 128, "float32", True, None),
    # the wide kernel's edges: at hd 256 a window of 100 keys, which crosses
    # its 16-key tiles and their 8-key halves, over three 64-row query tiles;
    # GQA (four query heads a KV head) at hd 96
    "hd256_window100_sq192": (1, 2, 1, 192, 192, 256, "float32", True, 100),
    "hd96_group4_window40": (1, 8, 2, 128, 128, 96, "float32", True, 40),
}
#: the order that seeds each attention case's inputs: the first cases by
#: name, then the later ones as they were added, so that adding a case
#: leaves the inputs of the others as they were
_ATTENTION_ADDED = ("window100_sq320", "bf16_hd128", "hd96", "hd256_mqa_window",
                    "hd256_non_causal", "hd256_cross_lengths", "bf16_hd96", "bf16_hd256",
                    "hd96_ragged", "hd256_ragged_blind", "group6_hd128",
                    "hd256_window100_sq192", "hd96_group4_window40")
ATTENTION_SEED_ORDER = (*sorted(set(ATTENTION_CASES) - set(_ATTENTION_ADDED)),
                        *_ATTENTION_ADDED)


#: the flash-attention kernel against its plain version, by dtype: (atol,
#: rtol). fp32: both sum in fp32 in different orders (hd products, up to
#: 8192 keys), ~1e-6 expected, 1e-4 allowed — 20x inside the reference's
#: own 2e-3 for its kernel; bf16: the same fp32 result rounded to bf16 on
#: both sides may land one bf16 ulp (2**-7 relative) apart
ATTENTION_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -7)}


def attention_case(name: str) -> dict:
    """One case of :data:`ATTENTION_CASES` as a dict of its fields."""
    return dict(zip(ATTENTION_FIELDS, ATTENTION_CASES[name]))


def attention_inputs(name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """fp32 q (B,H,Sq,hd), k and v (B,KV,Sk,hd), standard normal from a
    seed of the case's own; callers cast them to the case's dtype."""
    c = attention_case(name)
    rng = np.random.default_rng(ATTENTION_SEED_ORDER.index(name) + 17)
    q = rng.standard_normal((c["B"], c["H"], c["sq"], c["hd"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["KV"], c["sk"], c["hd"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["KV"], c["sk"], c["hd"])).astype(np.float32)
    return q, k, v


#: the sLSTM-scan cases: batch, sequence length, chunk, heads, head dim, gx
#: dtype, and the range of the gate inputs (None = standard normal, x =
#: uniform in [-x, x])
SLSTM_FIELDS = ("B", "S", "chunk", "H", "hd", "dtype", "gate_range")
SLSTM_CASES: dict[str, tuple] = {
    # the sweep of tests/test_slstm_kernel.py at smoke width (4 heads of 64)
    "b2_s32_c8": (2, 32, 8, 4, 64, "float32", None),
    "b1_s64_c16": (1, 64, 16, 4, 64, "float32", None),
    "b3_s32_c32": (3, 32, 32, 4, 64, "float32", None),
    # full width: xlstm-125m's 4 heads of 192
    "full_width": (2, 64, 16, 4, 192, "float32", None),
    # a head dim that is no multiple of a warp
    "hd48": (2, 32, 16, 4, 48, "float32", None),
    "bf16": (1, 32, 8, 4, 64, "bfloat16", None),
    # the sequence as several of the reference's 256-step chunks
    "three_chunks": (2, 768, 256, 4, 64, "float32", None),
    # gate inputs at +-30: tanh and sigmoid saturate, log_sigmoid reaches
    # -30, and exp(i - m) spans its range
    "large_gates": (2, 32, 8, 4, 64, "float32", 30.0),
    # the largest head dim the kernel takes: one gate's r does not fit a
    # block's shared memory, so each gate spans 2 CTAs (a cluster of 8)
    "hd256": (1, 32, 8, 2, 256, "float32", None),
}
#: the order that seeds each sLSTM case's inputs (see ATTENTION_SEED_ORDER)
_SLSTM_ADDED = ("hd256",)
SLSTM_SEED_ORDER = (*sorted(set(SLSTM_CASES) - set(_SLSTM_ADDED)), *_SLSTM_ADDED)

#: the sLSTM-scan kernel against its plain version on the card, h and the
#: final state: (atol, rtol). Both widen gx to fp32 the same way and run the
#: same fp32 gate math; they differ in the order of the hd products of each
#: step (~1e-7 relative), and the recurrence does not amplify that (|h| <= 1,
#: r is small): ~1e-6 expected, 1e-4 allowed, as for flash attention. bf16 gx
#: is widened identically on both sides, so it needs no wider tolerance.
SLSTM_TOL = (1e-4, 1e-4)


def slstm_case(name: str) -> dict:
    """One case of :data:`SLSTM_CASES` as a dict of its fields."""
    return dict(zip(SLSTM_FIELDS, SLSTM_CASES[name]))


def slstm_inputs(name: str) -> tuple[np.ndarray, np.ndarray]:
    """fp32 gx (B, S, 4, H * hd) and r (4, H, hd, hd) from a seed of the
    case's own: gx standard normal (or uniform in the case's range), r
    normal * 0.05 as in ``tests/test_slstm_kernel.py``; callers cast gx to
    the case's dtype."""
    c = slstm_case(name)
    rng = np.random.default_rng(SLSTM_SEED_ORDER.index(name) + 31)
    shape = (c["B"], c["S"], 4, c["H"] * c["hd"])
    if c["gate_range"] is None:
        gx = rng.standard_normal(shape)
    else:
        gx = rng.uniform(-c["gate_range"], c["gate_range"], shape)
    r = rng.standard_normal((4, c["H"], c["hd"], c["hd"])) * 0.05
    return gx.astype(np.float32), r.astype(np.float32)
