"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

Each kernel against its plain PyTorch version on the card, on the edge
cases every implementation must agree on: quantize and dequantize
bitwise, the fold bitwise (both round once: the kernel's ``fmaf`` and the
plain version's float64 round-to-odd sum), and the 4-bit quantize and
dequantize bitwise for nf4 and fp4, the K-way dequantize-and-sum bitwise
(both are K folds in order, each one rounding) — with NaN in the same
places where a case holds NaN (a NaN's payload bits are not compared: the card's
arithmetic returns its canonical NaN). Flash attention is held to the
tolerances ``kernels/cases.py`` states (``ATTENTION_TOL``, which
``chip_smoke.py`` uses too) at head dims 64, 96, 128 and 256, refuses
another head dim and any layout but its own, holds 8 warps on an SM at
the wide head dims, and its backward must raise; so is the sLSTM scan
(``SLSTM_TOL``, h and the final state), at
head dims that take each cluster layout too, whose backward must raise.
Each new model family (MoE, hybrid, enc-dec, VLM and the dense configs)
serves at smoke width on the card as on the CPU. Two gloo ranks on the
card run the int8 collective against the same collective on the CPU,
bitwise. The quantize and dequantize filters
launch one kernel per item, and ``examples/jobs/legacy_quantized.json``
at smoke width with fixed updates gives the CPU's weights and wire bytes
on the card, in container and regular transmission. The LoRA plane:
the card's SVD gives the same factors twice with canonical signs and
the CPU's fidelity, ``topk`` and ``bf16`` give the CPU's bits, and
``examples/jobs/lora_federation.json`` with fixed updates gives the
CPU's nf4 items and envelopes (but the factors' own bits) with weights
within the SVDs' bound (``repro_torch.testing.lora_fixed_bounds``).
The centralized trainer: two smoke-width ``train_loop`` steps of each
family on the card give the CPU's losses and weights within the CPU
tests' bounds, and a step at seq 128 (through the flash kernel) raises.
A round's ``wall_s`` in the controller's ``round_log`` covers the fold
its aggregator left queued on the card. Imports torch and the port only, so it runs on the card machine, which
has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere the tests skip.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import testing  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    ATTENTION_CASES,
    ATTENTION_TOL,
    FOLD_WEIGHTS,
    SLSTM_CASES,
    SLSTM_TOL,
    agg_cases,
    attention_case,
    attention_inputs,
    blockwise8_cases,
    fold_accumulator,
    fourbit_cases,
    one_block_folds,
    slstm_case,
    slstm_inputs,
    subnormal_accumulator,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.quant_blockwise8 import (  # noqa: E402
    dequantize_blockwise8,
    quantize_blockwise8,
)

from repro_torch.kernels.quant_nf4 import dequantize_4bit, quantize_4bit  # noqa: E402
from repro_torch.kernels.slstm_scan import slstm_scan  # noqa: E402

CASES = blockwise8_cases()
CASES4 = fourbit_cases()
AGG_CASES = agg_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(a, b):
    """Bitwise equal, NaN in the same places (payloads not compared)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(_bits(a)[~nan], _bits(b)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_bitwise_equal_plain_versions_on_the_card(cuda, name):
    x2d = ops.pad_to_blocks(torch.from_numpy(CASES[name]).to(cuda))
    before = ops.launch_counts()
    q, am = quantize_blockwise8(x2d)
    q_p, am_p = ref.quantize_blockwise8(x2d)
    assert torch.equal(q, q_p) and _same(am, am_p)
    d = dequantize_blockwise8(q, am)
    assert _same(d, ref.dequantize_blockwise8(q, am))
    for w in FOLD_WEIGHTS:
        acc0 = torch.from_numpy(fold_accumulator(q.shape[0])).to(cuda)
        k = ops.dequant_accumulate8_into(acc0.clone(), q, am, w)
        p = ref.dequant_accumulate8_into(acc0.clone(), q, am, w)
        assert _same(k, p), w
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["quantize_blockwise8"] - before["quantize_blockwise8"] == 1
    assert after["dequantize_blockwise8"] - before["dequantize_blockwise8"] == 1
    assert after["dequant_accumulate8_into"] - before["dequant_accumulate8_into"] == len(FOLD_WEIGHTS)


@pytest.mark.cuda
@pytest.mark.parametrize("weight", FOLD_WEIGHTS)
def test_fold_kernel_flushes_subnormals_like_its_plain_version(cuda, weight):
    x2d = ops.pad_to_blocks(torch.from_numpy(CASES["subnormal"]).to(cuda))
    q, am = quantize_blockwise8(x2d)
    acc0 = torch.from_numpy(subnormal_accumulator(q.shape[0])).to(cuda)
    k = ops.dequant_accumulate8_into(acc0.clone(), q, am, weight)
    p = ref.dequant_accumulate8_into(acc0.clone(), q, am, weight)
    assert torch.equal(_bits(k), _bits(p))


@pytest.mark.cuda
@pytest.mark.parametrize("weight", FOLD_WEIGHTS + (3.0, 1 / 3))
def test_one_block_folds_on_the_card_bitwise_equal_the_plain_version(cuda, weight):
    """At one block the fold's scale is ``(absmax * f32(1/127)) * w``
    (``kernels.ref.fold_scale``): 64 single-block items, into an
    accumulator, and the K-way sum of three of them."""
    acc0 = torch.from_numpy(fold_accumulator(1)).to(cuda)
    folds = [(torch.from_numpy(q).to(cuda), torch.from_numpy(am).to(cuda))
             for q, am in one_block_folds()]
    for q, am in folds:
        k = ops.dequant_accumulate8_into(acc0.clone(), q, am, weight)
        p = ref.dequant_accumulate8_into(acc0.clone(), q, am, weight)
        assert torch.equal(_bits(k), _bits(p))
    qs = torch.stack([q for q, _ in folds[:3]])
    ams = torch.stack([am for _, am in folds[:3]])
    ws = torch.tensor([weight, 0.37, 3.0], dtype=torch.float32, device=cuda)
    assert torch.equal(_bits(ops.dequant_accumulate8(qs, ams, ws)),
                       _bits(ref.dequant_accumulate8(qs, ams, ws)))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["nf4", "fp4"])
@pytest.mark.parametrize("name", sorted(CASES4))
def test_fourbit_kernels_bitwise_equal_plain_versions_on_the_card(cuda, name, fmt):
    x2d = ops.pad_to_blocks(torch.from_numpy(CASES4[name]).to(cuda), ref.BLOCK4)
    before = ops.launch_counts()
    p, am = quantize_4bit(x2d, fmt)
    p_p, am_p = ref.quantize_4bit(x2d, fmt)
    assert p.dtype == torch.uint8 and p.shape == (x2d.shape[0], ref.BLOCK4 // 2)
    assert torch.equal(p, p_p) and _same(am, am_p)
    d = dequantize_4bit(p, am, fmt)
    assert _same(d, ref.dequantize_4bit(p, am, fmt))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["quantize_4bit"] - before["quantize_4bit"] == 1
    assert after["dequantize_4bit"] - before["dequantize_4bit"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks", [1, 2, 3, 31, 33, 4099])
def test_fourbit_kernels_cover_any_block_count(cuda, nblocks):
    """Ragged grids: the last warp of quantize holds half a warp's worth
    of blocks or less, the last CTA of either kernel is partly masked."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(nblocks)
    x2d = torch.randn((nblocks, ref.BLOCK4), generator=gen, device=cuda)
    p, am = quantize_4bit(x2d, "nf4")
    p_p, am_p = ref.quantize_4bit(x2d, "nf4")
    assert torch.equal(p, p_p) and torch.equal(_bits(am), _bits(am_p))
    d = dequantize_4bit(p, am, "nf4")
    assert torch.equal(_bits(d), _bits(ref.dequantize_4bit(p, am, "nf4")))


@pytest.mark.cuda
def test_absmax_keeps_nan_and_inf_on_the_card(cuda):
    """The ``nan_inf`` blocks: NaN absmax for a block holding NaN (all
    blockwise8 codes 0), inf for one holding an infinity only — as the
    reference gives them."""
    x = torch.from_numpy(CASES["nan_inf"]).to(cuda)
    q, am = quantize_blockwise8(ops.pad_to_blocks(x))
    assert torch.isnan(am[[0, 3]]).all() and torch.isinf(am[[1, 2]]).all()
    assert torch.isfinite(am[4]) and (q[[0, 3]] == 0).all()
    _p, am4 = quantize_4bit(ops.pad_to_blocks(torch.from_numpy(CASES4["nan_inf"]).to(cuda),
                                              ref.BLOCK4), "nf4")
    assert torch.isnan(am4[[0, 3]]).all() and torch.isinf(am4[[1, 2]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ATTENTION_CASES))
def test_flash_kernel_matches_its_plain_version_on_the_card(cuda, name):
    c = attention_case(name)
    dtype = getattr(torch, c["dtype"])
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in attention_inputs(name))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=c["causal"], window=c["window"])
    want = ref.attention(q, k, v, causal=c["causal"], window=c["window"])
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 1
    assert out.dtype == dtype and out.shape == q.shape
    atol, rtol = ATTENTION_TOL[c["dtype"]]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_refuses_a_layout_that_is_not_its_own_on_the_card(cuda, hd, dtype):
    """The source recomputes the wrapper's layout and refuses a launch with
    any other rows, warps or shared bytes (the launch never runs)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.zeros((1, 2, 64, hd), device=cuda, dtype=dt) for _ in range(3))
    out = torch.empty_like(q)
    lay = FA.layout(hd, dt)
    for rows, warps, smem in ((lay.rows * 2, lay.warps, lay.smem_bytes),
                              (lay.rows, lay.warps // 2, lay.smem_bytes),
                              (lay.rows, lay.warps, lay.smem_bytes + 16)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            _build.launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(), 1, 2, 2, 64, 64, hd,
                          int(dt == torch.bfloat16), 1, 0, 0, hd ** -0.5, rows, warps, smem)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_flash_kernel_holds_8_warps_an_sm_without_spills_on_the_card(cuda, hd, dtype):
    occ = FA.occupancy(hd, getattr(torch, dtype))
    assert occ["warps_per_sm"] >= 8, occ
    assert occ["local_bytes"] == 0, occ


@pytest.mark.cuda
def test_flash_kernel_refuses_a_head_dim_it_was_not_built_for_on_the_card(cuda):
    q, k, v = (torch.zeros((1, 2, 128, 80), device=cuda) for _ in range(3))
    with pytest.raises(ValueError, match="built for"):
        flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b", "whisper-small",
                                  "llama4-scout-17b-a16e", "recurrentgemma-2b", "granite-8b",
                                  "phi-3-vision-4.2b", "qwen2.5-32b"])
def test_family_serving_on_the_card_matches_the_cpu(cuda, arch):
    """Smoke width, the same seeded weights on the card (a 128-row
    prefill: each attention layer through the flash kernel) and on the
    CPU: prefill logits and caches within 1e-5 * (1 + |want|), greedy
    tokens equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.utils.trees import flatten_state_dict, unflatten_state_dict

    cfg = get_smoke_config(arch).with_overrides(remat=False)
    model = create_model(cfg)
    cpu_params = model.init(0, "cpu")
    card_params = unflatten_state_dict(
        {k: v.to(cuda) for k, v in flatten_state_dict(cpu_params).items()})
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 128 - (cfg.num_patches if cfg.family == "vlm" else 0))
    ).astype(np.int32))
    extra = {}
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_seq if cfg.family == "encdec" else cfg.num_patches
        key = "frames" if cfg.family == "encdec" else "patches"
        extra[key] = torch.from_numpy(
            rng.standard_normal((2, n, cfg.d_model)).astype(np.float32))
    outs = {}
    before = flash_attention.launches
    for d, params in (("cpu", cpu_params), (cuda, card_params)):
        ex = {k: v.to(d) for k, v in extra.items()}
        with torch.inference_mode():
            logits, cache = model.prefill(params, prompts.to(d), *ex.values())
        tokens = generate(model, params, prompts.to(d), gen_len=6, extra=ex or None)
        outs[str(d)] = [logits.cpu()] + [t.cpu() for t in flatten_state_dict(cache).values()]
        outs[str(d) + "_tokens"] = tokens.cpu()
    torch.cuda.synchronize()
    assert flash_attention.launches > before
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        assert bool(((got.float() - want.float()).abs() <= 1e-5 * (1 + want.abs())).all())
    assert torch.equal(outs[str(cuda) + "_tokens"], outs["cpu_tokens"])


@pytest.mark.cuda
def test_flash_kernel_is_forward_only_on_the_card(cuda):
    q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_(True)
               for a in attention_inputs("group2"))
    out = flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(AGG_CASES))
def test_agg_kernel_bitwise_equals_its_plain_version_on_the_card(cuda, name):
    qs, am, w = (torch.from_numpy(a).to(cuda) for a in AGG_CASES[name])
    before = ops.launch_counts()["dequant_accumulate8"]
    out = ops.dequant_accumulate8(qs, am, w)
    want = ref.dequant_accumulate8(qs, am, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["dequant_accumulate8"] - before == 1
    assert out.dtype == torch.float32 and out.shape == qs.shape[1:]
    assert _same(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLSTM_CASES))
def test_slstm_kernel_matches_its_plain_version_on_the_card(cuda, name):
    c = slstm_case(name)
    gx, r = (torch.from_numpy(a).to(cuda) for a in slstm_inputs(name))
    gx = gx.to(getattr(torch, c["dtype"]))
    before = slstm_scan.launches
    h, state = slstm_scan(gx, r, num_heads=c["H"], chunk=c["chunk"])
    h_p, state_p = ref.slstm_scan(gx, r, c["H"])
    torch.cuda.synchronize()
    assert slstm_scan.launches - before == 1
    assert h.dtype == torch.float32 and h.shape == h_p.shape
    atol, rtol = SLSTM_TOL
    torch.testing.assert_close(h, h_p, atol=atol, rtol=rtol)
    for got, want in zip(state, state_p):
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [1, 17, 100, 224, 225, 240])
def test_slstm_kernel_takes_the_layout_of_any_head_dim_on_the_card(cuda, hd):
    """The wrapper's layout for head dims that pad rows, columns and warps
    differently, a cluster of 4 (hd <= 224) and of 8 (hd > 224), is the one
    the kernel accepts, and the kernel agrees with its plain version."""
    rng = np.random.default_rng(hd)
    gx = torch.from_numpy(rng.standard_normal((2, 24, 4, 2 * hd)).astype(np.float32)).to(cuda)
    r = torch.from_numpy((rng.standard_normal((4, 2, hd, hd)) * 0.05).astype(np.float32))
    h, state = slstm_scan(gx, r.to(cuda), num_heads=2, chunk=24)
    h_p, state_p = ref.slstm_scan(gx, r.to(cuda), 2)
    torch.cuda.synchronize()
    atol, rtol = SLSTM_TOL
    torch.testing.assert_close(h, h_p, atol=atol, rtol=rtol)
    for got, want in zip(state, state_p):
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_slstm_kernel_is_forward_only_on_the_card(cuda):
    gx, r = (torch.from_numpy(a).to(cuda).requires_grad_(True)
             for a in slstm_inputs("b2_s32_c8"))
    h, _state = slstm_scan(gx, r, num_heads=4, chunk=8)
    with pytest.raises(NotImplementedError, match="forward-only"):
        h.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("prompt", [200, 256])
def test_xlstm_prefill_routes_whole_chunks_through_the_scan_kernel(cuda, prompt):
    """On the card every prompt, a multiple of 256 or not, runs each sLSTM
    layer through the kernel: one launch per super-block."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import create_model
    model = create_model(get_smoke_config("xlstm-125m").with_overrides(remat=False))
    params = model.init(0, cuda)
    tokens = torch.zeros((2, prompt), dtype=torch.int32, device=cuda)
    before = slstm_scan.launches
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens)
    torch.cuda.synchronize()
    assert slstm_scan.launches - before == model.n_super
    assert bool(torch.isfinite(logits).all())
    assert all(bool(torch.isfinite(t).all()) for block in cache.values() for t in block.values())


def _collective_rank(rank, world, args):
    """The int8 collective (and its bucketed form) on the card and on the
    CPU, through one gloo group; returns host copies and the launches."""
    from repro_torch.core import collectives as C
    rng = np.random.default_rng(rank)
    x = torch.from_numpy((rng.standard_normal(5 * 4096 + 99) * 3).astype(np.float32))
    dev = torch.device("cuda", torch.cuda.current_device())
    ops.reset_launch_counts()
    card = C.quantized_pod_mean(x.to(dev))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    bucket = C.bucketed_quantized_pod_mean(x.to(dev), bucket_bytes=2 * 4096 * 4)
    cpu = C.quantized_pod_mean(x)
    return {"card": card.cpu().numpy(), "bucket": bucket.cpu().numpy(),
            "cpu": cpu.numpy(), "launches": launches}


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_cpu(cuda):
    from repro_torch.launch import fl_train
    args = argparse.Namespace(pods=2, device="cuda", backend="gloo")
    ranks = fl_train.launch(args, _collective_rank)
    for out in ranks:
        assert out["launches"]["quantize_blockwise8"] == 1
        assert out["launches"]["dequant_accumulate8"] == 1
        assert out["card"].tobytes() == out["cpu"].tobytes()
        assert out["bucket"].tobytes() == out["card"].tobytes()
    assert ranks[0]["card"].tobytes() == ranks[1]["card"].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,kernels", [
    ("blockwise8", ("quantize_blockwise8", "dequantize_blockwise8")),
    ("nf4", ("quantize_4bit", "dequantize_4bit")),
])
def test_filters_launch_one_kernel_per_item_on_the_card(cuda, fmt, kernels):
    """QuantizeFilter / DequantizeFilter work item by item, as the
    reference's do: one quantize launch per float item, one dequantize
    launch per quantized item, and the card's bytes are the CPU's."""
    from repro_torch.core.filters import DequantizeFilter, QuantizeFilter
    from repro_torch.core.messages import Message, MessageKind
    from repro_torch.core.serialization import serialize_item

    gen = torch.Generator().manual_seed(3)
    payload = {"a": torch.randn(4096 * 3 + 5, generator=gen),
               "b": torch.randn(64, 70, generator=gen),
               "c": torch.randn(7, generator=gen),
               "steps": torch.arange(4)}
    ops.reset_launch_counts()
    card = QuantizeFilter(fmt, device=cuda).process(
        Message(MessageKind.TASK_DATA, {k: v.to(cuda) for k, v in payload.items()}))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert launches[kernels[0]] == 3 and sum(launches.values()) == 3
    cpu = QuantizeFilter(fmt, device="cpu").process(Message(MessageKind.TASK_DATA, payload))
    for name in payload:
        assert serialize_item(name, card.payload[name]) == serialize_item(name, cpu.payload[name])
    ops.reset_launch_counts()
    back = DequantizeFilter(cuda).process(card)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert launches[kernels[1]] == 3 and sum(launches.values()) == 3
    want = DequantizeFilter("cpu").process(cpu)
    for name in ("a", "b", "c"):
        assert _same(back.payload[name].cpu(), want.payload[name])


@pytest.mark.cuda
@pytest.mark.parametrize("transmission", ["container", "regular"])
def test_legacy_round_on_the_card_matches_the_cpu(cuda, transmission):
    """``examples/jobs/legacy_quantized.json`` at smoke width with fixed
    client updates: the card and the CPU give the same final weights and
    the same wire bytes, and the card launches one B1 per item at each
    egress point and one B2 per item at each ingress point."""
    import json
    from pathlib import Path

    from repro_torch.fl.job import build_job, initial_weights

    spec = json.loads((Path(__file__).resolve().parents[1] / "examples" / "jobs"
                       / "legacy_quantized.json").read_text())
    spec["transmission"] = transmission
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}

    def fixed(index):
        def train_fn(_params, rnd):
            rng = np.random.default_rng((index, rnd))
            return ({k: v + rng.standard_normal(v.shape).astype(np.float32)
                     * np.float32(0.05 * (index + 1)) for k, v in init.items()},
                    3 + 5 * index, {})
        return train_fn

    outs = {}
    for dev in ("cpu", cuda):
        jb = build_job(spec, device=dev, weights=init)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = fixed(i)
        ops.reset_launch_counts()
        out = jb.run()
        outs[str(dev)] = (out, ops.launch_counts())
    (want, cpu_launches), (got, launches) = outs["cpu"], outs[str(cuda)]
    per_direction = spec["rounds"] * spec["clients"] * len(init)
    assert cpu_launches == {name: 0 for name in ops.KERNELS}
    assert launches == {**cpu_launches, "quantize_blockwise8": 2 * per_direction,
                        "dequantize_blockwise8": 2 * per_direction}
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["telemetry"]["memory"] == want["telemetry"]["memory"]
    for name, w in want["final_weights"].items():
        assert torch.equal(_bits(got["final_weights"][name].cpu()), _bits(w)), name


@pytest.mark.cuda
def test_fedbuff_flush_and_secagg_finish_on_the_card_equal_the_cpu(cuda):
    """FedBuff's delta fold and flush (``(value - base) * w`` summed, then
    ``w + lr * dsum / wsum``) and SecureAggregator's unmasked mean
    (``_from_grid(total) / n``) divide by device tensors, so the card
    gives the CPU's bits; weights, lr and sums are chosen so a multiply
    by a reciprocal would round differently somewhere."""
    from repro_torch.core import secure_agg as sa
    from repro_torch.core.messages import Message, MessageKind
    from repro_torch.runtime.async_agg import Dispatch, FedBuffPolicy

    gen = torch.Generator().manual_seed(0)
    base = {"w": torch.randn(1 << 16, generator=gen), "b": torch.randn(4099, generator=gen)}
    updates = [{k: v + torch.randn(v.shape, generator=gen) * 0.3 for k, v in base.items()}
               for _ in range(3)]
    outs = {}
    for dev in ("cpu", cuda):
        pol = FedBuffPolicy(3, buffer_size=3, server_lr=0.7, device=dev)
        dispatches = pol.begin(base, ["a", "b", "c"])
        for d, (n, upd) in zip(dispatches, zip((3, 7, 11), updates)):
            pol.on_result(Dispatch(d.client, d.task, d.version),
                          Message(MessageKind.TASK_RESULT,
                                  {k: v.to(dev) for k, v in upd.items()}, {"num_samples": n}))
        agg = sa.SecureAggregator(3, device=dev)
        for i, upd in enumerate(updates):
            agg.accept(sa.SecureMaskFilter(i, [0, 1, 2], device=dev).process(
                Message(MessageKind.TASK_RESULT, dict(upd), {"round": 0})))
        outs[str(dev)] = (pol.finish(), agg.finish())
    (want_w, want_m), (got_w, got_m) = outs["cpu"], outs[str(cuda)]
    for name in base:
        assert got_w[name].device.type == "cuda" and got_m[name].device.type == "cuda"
        assert torch.equal(_bits(got_w[name].cpu()), _bits(want_w[name])), name
        assert torch.equal(_bits(got_m[name].cpu()), _bits(want_m[name])), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["streaming_aggregation", "async_hetero_pipeline"])
def test_async_job_on_the_card_matches_the_cpu(cuda, name):
    """An example async job at smoke width with fixed client updates: the
    card and the CPU give the same timeline, runtime stats, wire bytes and
    final weights; every kernel the path implies launched on the card, as
    often as the spec's rules imply (``repro_torch.testing.async_launches``)."""
    import json
    from pathlib import Path

    from repro_torch.fl.job import build_job, initial_weights

    spec = json.loads((Path(__file__).resolve().parents[1] / "examples" / "jobs"
                       / f"{name}.json").read_text())
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}

    def fixed(index):
        def train_fn(_params, rnd):
            rng = np.random.default_rng((index, rnd))
            return ({k: v + rng.standard_normal(v.shape).astype(np.float32)
                     * np.float32(0.05 * (index + 1)) for k, v in init.items()},
                    3 + 5 * index, {})
        return train_fn

    outs = {}
    for dev in ("cpu", cuda):
        jb = build_job(spec, device=dev, weights=init)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = fixed(i)
        ops.reset_launch_counts()
        out = jb.run()
        timeline = [(e.kind.value, e.client, e.time, e.seq) for e in jb.sim.scheduler.timeline]
        outs[str(dev)] = (out, timeline, ops.launch_counts())
    (want, want_tl, cpu_launches), (got, got_tl, launches) = outs["cpu"], outs[str(cuda)]
    assert cpu_launches == {k: 0 for k in ops.KERNELS}
    assert got_tl == want_tl
    assert got["runtime_stats"] == want["runtime_stats"]
    assert got["sim_time_s"] == want["sim_time_s"]
    assert got["telemetry"]["traffic"] == want["telemetry"]["traffic"]
    assert got.get("adaptive_fmts") == want.get("adaptive_fmts")
    assert launches["dequant_accumulate8_into"] == 0
    if name == "streaming_aggregation":
        assert launches == {**{k: 0 for k in ops.KERNELS},
                            **testing.async_launches(spec, list(init))}
    for k, w in want["final_weights"].items():
        assert torch.equal(_bits(got["final_weights"][k].cpu()), _bits(w)), k


@pytest.mark.cuda
def test_lora_decompose_on_the_card_is_deterministic_canonical_and_the_cpus(cuda):
    """The card's SVD (``ops.SVD_DRIVER``) gives the same factors twice,
    canonical signs, and the CPU's fidelity ``||x - ab||_F`` within 1e-6
    relative."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(4096, 1024, generator=gen) * 0.02
    a, b = ops.low_rank_decompose(x.to(cuda), 8)
    a2, b2 = ops.low_rank_decompose(x.to(cuda), 8)
    assert torch.equal(_bits(a), _bits(a2)) and torch.equal(_bits(b), _bits(b2))
    rows = torch.arange(8, device=cuda)
    assert (b[rows, b.abs().argmax(dim=1)] > 0).all()
    ca, cb = ops.low_rank_decompose(x, 8)
    x64 = x.double()
    got = (x64 - a.cpu().double() @ b.cpu().double()).norm()
    want = (x64 - ca.double() @ cb.double()).norm()
    assert abs(float(got - want)) <= 1e-6 * float(want)


@pytest.mark.cuda
def test_topk_and_bf16_on_the_card_equal_the_cpu(cuda):
    """``topk`` selects by a stable sort on the card: the numpy selection's
    entries, NaNs of any sign last and ties in index order; ``bf16``
    narrows by bit arithmetic: the CPU's words, NaN as ``sign | 0x7fc0``."""
    from repro_torch.core import quantization as q
    from repro_torch.core.sparse import topk_sparsify

    words = np.random.default_rng(2).integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
    x = words.astype(np.uint32).view(np.float32)
    x[::97] = x[5]                                     # ties
    x[::89] = -x[5]
    for frac in (0.001, 0.3, 1.0):
        got = topk_sparsify(torch.from_numpy(x).to(cuda), frac)
        want = topk_sparsify(x, frac)
        assert got.indices.tobytes() == want.indices.tobytes()
        assert got.values.tobytes() == want.values.tobytes()
    t = torch.from_numpy(x)
    narrow = q.narrow_bf16(t.to(cuda)).view(torch.int16).cpu()
    assert torch.equal(narrow, q.narrow_bf16(t).view(torch.int16))
    assert torch.equal(_bits(q.widen_bf16(narrow.view(torch.bfloat16).to(cuda)).cpu()),
                       _bits(q.widen_bf16(narrow.view(torch.bfloat16))))


@pytest.mark.cuda
def test_lora_job_on_the_card_matches_the_cpu(cuda):
    """``examples/jobs/lora_federation.json`` at smoke width with fixed
    client updates, card vs CPU (``repro_torch.testing.lora_wire_compare``):
    the same envelopes but the factors' bits and crc32 digits, the nf4
    items bitwise, global weights within
    ``repro_torch.testing.lora_fixed_bounds``; B4 and B5 launched as
    ``repro_torch.testing.lora_launches`` says."""
    import json
    from pathlib import Path

    from repro_torch.fl.job import build_job, initial_weights

    with open(Path(__file__).resolve().parents[1] / "examples" / "jobs"
              / "lora_federation.json") as fh:
        spec = json.load(fh)
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}
    outs = {}
    for dev in ("cpu", cuda):
        jb = build_job(spec, device=dev, weights=init)
        log = testing.envelope_log(jb.sim.proxies[0].pipelines["task_result"])
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = testing.fixed_train_fn(init, i, 0.05 * (i + 1))
        ops.reset_launch_counts()
        outs[str(dev)] = (jb.run(), log, ops.launch_counts())
    (want, want_log, cpu_launches), (got, got_log, launches) = outs["cpu"], outs[str(cuda)]
    assert cpu_launches == {k: 0 for k in ops.KERNELS}
    assert launches == {**{k: 0 for k in ops.KERNELS},
                        **testing.lora_launches(spec, {k: v.shape for k, v in init.items()})}
    cmp = testing.lora_wire_compare(want_log, got_log)
    assert cmp["holds"] and got["wire_bytes"] - want["wire_bytes"] == cmp["crc_digit_diff"]
    want_w = {k: v.numpy() for k, v in want["final_weights"].items()}
    errs = testing.relative_errors(want_w,
                                   {k: v.cpu() for k, v in got["final_weights"].items()})
    factored = testing.lora_factor_bytes(spec, {k: v.shape for k, v in init.items()})[1]
    bounds = testing.lora_fixed_bounds(spec, init, want_w, factored)
    assert all(errs[n] <= bounds[n] for n in factored), (errs, bounds)
    assert all(errs[n] == 0 for n in set(init) - set(factored)), errs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b", "phi-3-vision-4.2b", "xlstm-125m",
                                  "recurrentgemma-2b", "whisper-small"])
def test_training_on_the_card_matches_the_cpu(cuda, arch):
    """Smoke width, from the same weights on the card and on the CPU,
    random frames / patches: the first gradient leaf by leaf
    (``testing.gradient_counts``: each leaf within 1e-5 of its own
    largest, a zero-gradient leaf rounding on both), then three
    ``train_loop`` steps (the first at lr 0, so the last loss follows an
    update): losses within 1e-5 relative and the weights under
    ``testing.trained_counts`` (the CPU tests' bounds); no kernel
    launches (32 tokens, and 16 patches + 32 for the VLM: the masked
    softmax)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import train_loop
    from repro_torch.models import create_model
    from repro_torch.utils.device import disable_tf32
    from repro_torch.utils.trees import flatten_state_dict, tree_leaves, unflatten_state_dict

    disable_tf32()
    steps, lr = 3, 3e-4
    cfg = get_smoke_config(arch)
    model = create_model(cfg)
    zero = testing.zero_gradient_leaves(cfg)
    init = flatten_state_dict(model.init(0, "cpu"))
    rng = np.random.default_rng(5)
    extra = {}
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_seq if cfg.family == "encdec" else cfg.num_patches
        extra["frames" if cfg.family == "encdec" else "patches"] = \
            rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
    first = {k: torch.from_numpy(v).long()
             for k, v in SyntheticLMDataset(cfg.vocab_size, 32, seed=0).sample(2).items()}
    first.update({k: torch.from_numpy(v) for k, v in extra.items()})
    grads = {}
    before = ops.launch_counts()
    for d in ("cpu", cuda):
        params = unflatten_state_dict({k: v.to(d).clone().requires_grad_(True)
                                       for k, v in init.items()})
        g = torch.autograd.grad(model.loss(params, {k: v.to(d) for k, v in first.items()})[0],
                                tree_leaves(params))
        grads[str(d)] = {k: v.cpu() for k, v in zip(flatten_state_dict(params), g)}
    counts = testing.gradient_counts(grads["cpu"], grads[str(cuda)], zero, 1e-5)
    assert counts["holds"], counts
    outs = {}
    for d in ("cpu", cuda):
        params, history = train_loop(cfg, steps=steps, batch_size=2, seq_len=32, lr=lr,
                                     params={k: v.clone() for k, v in init.items()},
                                     log_every=0, extra_batch=extra or None, device=d)
        outs[str(d)] = ({k: v.detach().cpu() for k, v in flatten_state_dict(params).items()},
                        history)
    assert ops.launch_counts() == before
    (want, want_h), (got, got_h) = outs["cpu"], outs[str(cuda)]
    np.testing.assert_allclose(got_h, want_h, rtol=1e-5)
    counts = testing.trained_counts(want, got, zero, sign_flips=2 * lr * steps)
    assert counts["holds"], counts


@pytest.mark.cuda
def test_training_at_seq_128_raises_on_the_card(cuda):
    """Seq 128 routes attention to the flash kernel, which has no
    gradient (ROADMAP C13): the step raises in the backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train_loop

    before = flash_attention.launches
    with pytest.raises(NotImplementedError, match="forward-only"):
        train_loop(get_smoke_config("llama3.2-1b"), steps=1, batch_size=2, seq_len=128,
                   log_every=0, device=cuda)
    assert flash_attention.launches > before


@pytest.mark.cuda
def test_cuda_tensors_launch_or_raise_while_meta_takes_the_plain_version(cuda):
    """The dispatch rule on the card's side: meta tensors (the dry run)
    take B7's and B8's plain versions and launch nothing, while CUDA
    tensors the kernels cannot take raise — B7 at a head dim it was not
    built for, B8 past its largest head dim — and never fall back."""
    before = ops.launch_counts()
    q = torch.zeros((1, 4, 128, 64), device="meta")
    assert tuple(flash_attention(q, q, q, causal=True).shape) == (1, 4, 128, 64)
    h, _state = slstm_scan(torch.zeros((1, 8, 4, 64), device="meta"),
                           torch.zeros((4, 2, 32, 32), device="meta"), num_heads=2, chunk=8)
    assert tuple(h.shape) == (1, 8, 64)
    assert ops.launch_counts() == before
    q = torch.zeros((1, 2, 128, 32), device=cuda)
    with pytest.raises(ValueError, match="built for"):
        flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        slstm_scan(torch.zeros((1, 8, 4, 512), device=cuda),
                   torch.zeros((4, 1, 512, 512), device=cuda), num_heads=1, chunk=8)
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_round_wall_time_counts_the_fold_queued_on_the_card(cuda):
    """``ScatterAndGather`` waits for the card the new global weights live
    on before it reads the round's clock: a fold that returns at once but
    leaves a long kernel queued is in ``wall_s``."""
    import time

    from repro_torch.core.messages import Message, MessageKind
    from repro_torch.fl.controller import ClientProxy, ScatterAndGather

    class Client(ClientProxy):
        name = "site-0"

        def submit_task(self, task, result_sink=None):
            return Message(MessageKind.TASK_RESULT, {}, headers={})

    class QueuedFold:
        def accept(self, result):
            pass

        def finish(self):
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            self.start.record()
            torch.cuda._sleep(500_000_000)      # a few hundred ms of cycles
            w = torch.ones(4, device=cuda)
            self.end.record()
            self.host_s = time.perf_counter() - t0
            return {"w": w}

    torch.cuda.synchronize()
    fold = QueuedFold()
    controller = ScatterAndGather([Client()], fold, num_rounds=1)
    controller.run({"w": torch.zeros(4, device=cuda)})
    kernel_s = fold.start.elapsed_time(fold.end) / 1e3
    assert kernel_s > 0.05 and fold.host_s < kernel_s / 5, (kernel_s, fold.host_s)
    assert controller.round_log[0]["wall_s"] >= kernel_s
