"""What "correct" means for the port's slices, in one place.

The parity contracts that both the CPU tests (``tests/test_torch_*.py``,
the port against the JAX reference) and the card's smoke script
(``chip_smoke.py``, the card against the CPU) hold a run to: the client
updates that fix a federation's inputs, the launches a path implies from
its spec, C1's bound on trained weights, and the LoRA plane's wire and
weight comparisons. Pure functions of specs, shapes, tensors and
envelope bytes; nothing here runs a kernel.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

#: C1's bound on the async paths' trained weights (:func:`c1_counts`): the
#: share of elements that may exceed one blockwise8 step by a 4-bit code
#: gap (a code that flipped on a hop), and the share that may exceed that
#: by AdamW's sign-flip term
NF4_FLIP_SHARE = 1e-4
SIGN_FLIP_SHARE = 1e-5


def fixed_train_fn(init: dict, index: int, scale: float):
    """A client update that is a seeded function of (client, round) only."""
    def train_fn(_params, rnd):
        rng = np.random.default_rng((index, rnd))
        return ({k: v + rng.standard_normal(v.shape).astype(np.float32) * np.float32(scale)
                 for k, v in init.items()}, 3 + 5 * index, {})
    return train_fn


def separated_train_fn(init: dict, index: int, scale: float, rank: int = 8):
    """:func:`fixed_train_fn`'s update with a well-separated rank-``rank``
    part added to every item that a rank-``rank`` truncation can cut
    (two or more dims, more than ``rank`` rows and columns once the
    leading dims collapse): seeded orthonormal ``u (m, r)`` and ``w (n,
    r)`` scaled by singular values ``20 f (2 - k / r)``, k = 0..r-1, with
    ``f = (std(init) + scale)(sqrt(m) + sqrt(n))`` about the largest
    singular value of the item's initial weights plus the noise. So
    ``sigma_r / sigma_{r+1} >~ 22`` and the truncation is well
    conditioned: two exact SVDs agree to a few ulps, and a fault the size
    of a TF32 or bf16 rounding, or a client weight off by 0.2 %, stands
    well above :func:`lora_fixed_bounds` (the Gaussian updates of
    :func:`fixed_train_fn` have ``sigma_1 / (sigma_r - sigma_{r+1})`` up
    to 5,638, where such faults can hide in the bound)."""
    noisy = fixed_train_fn(init, index, scale)

    def train_fn(params, rnd):
        values, n_samples, meta = noisy(params, rnd)
        rng = np.random.default_rng((index, rnd, rank))
        out = {}
        for k, v in values.items():
            x = v.reshape(-1, v.shape[-1]) if v.ndim >= 2 else v
            if v.ndim < 2 or min(x.shape) <= rank:
                out[k] = v
                continue
            m, n = x.shape
            f = (float(np.std(init[k])) + scale) * (math.sqrt(m) + math.sqrt(n))
            u = np.linalg.qr(rng.standard_normal((m, rank)))[0]
            w = np.linalg.qr(rng.standard_normal((n, rank)))[0]
            s = 20 * f * (2 - np.arange(rank) / rank)
            out[k] = (x + ((u * s) @ w.T).astype(np.float32)).reshape(v.shape)
        return out, n_samples, meta
    return train_fn


def block_step(want, got, block: int, step: float):
    """Per element: ``step`` times the larger absmax of its ``block``-element
    block in ``want`` or ``got`` (the flat wire layout)."""
    flat_w, flat_g = want.reshape(-1).abs(), got.reshape(-1).abs()
    pad = -flat_w.numel() % block
    am = torch.maximum(torch.nn.functional.pad(flat_w, (0, pad)),
                       torch.nn.functional.pad(flat_g, (0, pad)))
    return am.reshape(-1, block).amax(1).repeat_interleave(block)[:flat_w.numel()] * step


def c1_counts(want: dict, got: dict, sign_flips: float) -> dict:
    """Trained weights ``got`` against ``want`` under C1's bound for the
    async paths. Each element must lie within one blockwise8 step of its
    block + 1e-5 relative (the step bound); at most a
    :data:`NF4_FLIP_SHARE` of them (a 4-bit code that flipped on a hop)
    one nf4 code gap of its 64-block more (the gap bound); at most a
    :data:`SIGN_FLIP_SHARE` AdamW's ``sign_flips`` more, and none beyond
    that. Returns the element count, the counts beyond the step and the
    gap bounds, whether all of it holds, and the worst ratio to each."""
    from repro_torch.kernels.ref import BLOCK4, BLOCK8, NF4_CODE

    gap = float(np.diff(np.sort(NF4_CODE)).max())
    n = beyond_step = beyond_gap = 0
    within_all = True
    worst_step = worst_gap = 0.0
    for name, w in want.items():
        g = got[name]
        step = block_step(w, g, BLOCK8, 1 / 127) + 1e-5 * w.abs().reshape(-1)
        gap_bound = step + block_step(w, g, BLOCK4, gap)
        err = (g - w).abs().reshape(-1)
        n += err.numel()
        beyond_step += int((err > step).sum())
        beyond_gap += int((err > gap_bound).sum())
        within_all &= bool((err <= gap_bound + sign_flips).all())
        worst_step = max(worst_step, float((err / step).nan_to_num(posinf=math.inf).max()))
        worst_gap = max(worst_gap, float((err / gap_bound).nan_to_num(posinf=math.inf).max()))
    holds = (within_all and beyond_step <= NF4_FLIP_SHARE * n
             and beyond_gap <= SIGN_FLIP_SHARE * n)
    return {"elements": n, "beyond_step": beyond_step, "beyond_gap": beyond_gap,
            "holds": holds, "worst_of_step": worst_step, "worst_of_gap": worst_gap}


def async_formats(spec: dict, hop: str, names: list[str]) -> dict[str, str | None]:
    """Each item's format on one hop (``task_data`` or ``task_result``),
    read from the spec's own ``"quantize:..."`` string, not from the
    stage that runs it: ``pattern=fmt`` entries are rules, the first
    pattern found in the item's name decides and ``keep`` keeps the item;
    the entry without ``=`` is the default. Every item of these models is
    a float tensor and the stage quantizes any size, so no item is
    skipped for its dtype or size. A hop without such a stage: None."""
    fmts: dict[str, str | None] = dict.fromkeys(names)
    for stage in spec["pipeline"].get(f"{hop}_out", []):
        if not (isinstance(stage, str) and stage.startswith("quantize:")):
            continue
        rules, default = [], None
        for entry in stage.split(":", 1)[1].split(","):
            pattern, is_rule, fmt = entry.partition("=")
            if is_rule:
                rules.append((pattern, None if fmt in ("", "keep") else fmt))
            else:
                default = pattern
        fmts = {name: next((f for p, f in rules if p in name), default) for name in names}
    return fmts


def async_launches(spec: dict, names: list[str]) -> dict[str, int]:
    """The launches the async streaming path implies, from the spec's
    formats (:func:`async_formats`): the uplink is encoded twice a
    dispatch (the byte-pricing pass and the fold transfer), one fused B1
    group each; one fused B4 group a downlink; one B5 a downlinked nf4
    item on the client; one B2 an uplinked blockwise8 item in the fold;
    no B3 (FedBuff folds dense values)."""
    tasks = spec["runtime"]["total_tasks"]
    down = list(async_formats(spec, "task_data", names).values())
    up = list(async_formats(spec, "task_result", names).values())
    return {"quantize_blockwise8": 2 * tasks * ("blockwise8" in up),
            "quantize_4bit": tasks * ("nf4" in down),
            "dequantize_4bit": tasks * down.count("nf4"),
            "dequantize_blockwise8": tasks * up.count("blockwise8")}


def live_launches(spec: dict, uplink_log: list) -> dict[str, int]:
    """The launches a live run implies (``launch/federation.py``), from
    its spec and the server's grant log (``FederationServer.uplink_log``),
    restarted folds and re-grants included. Each grant has the client
    encode its cached round result once: one fused B1 group when the
    uplink quantizes to blockwise8. Each item that reached a fold costs
    the server one B3 when the aggregator folds wire form
    (``quantized-fedavg``), else one B2 (dense ``fedavg`` decodes the
    item first, as ``live_smoke.json`` and ``chaos_federation.json`` do:
    neither names an aggregator). For specs whose downlink has no stage."""
    from repro_torch.fl.aggregator import aggregator_consumes_wire
    from repro_torch.fl.job import aggregator_spec

    pipeline = spec.get("pipeline") or {}
    if pipeline.get("task_data_out") or pipeline.get("task_data"):
        raise ValueError("live_launches counts uplink kernels only; this spec's "
                         "downlink has stages")
    if "quantize:blockwise8" not in pipeline.get("task_result_out", []):
        return {}
    fold = ("dequant_accumulate8_into" if aggregator_consumes_wire(aggregator_spec(spec))
            else "dequantize_blockwise8")
    return {"quantize_blockwise8": sum(e["granted"] for e in uplink_log),
            fold: sum(e["items"] for e in uplink_log)}


def _uplink_stage(spec: dict, name: str):
    from repro_torch.core.pipeline import build_stage

    return next(s for s in map(build_stage, spec["pipeline"]["task_result_out"])
                if s.name == name)


def lora_fixed_bounds(spec: dict, init: dict, want: dict, names: list[str],
                      train_fn=fixed_train_fn) -> dict:
    """How far two exact SVDs (card and CPU, or the two packages) may
    leave each factored global item of a lora run whose client ``i``
    sends ``train_fn(init, i, 0.05 (i + 1))`` (:func:`fixed_train_fn` or
    :func:`separated_train_fn`), as a relative Frobenius error of
    ``want``, the last round's weighted mean of each client's rank-r
    truncation ``A_i``. Each SVD is backward stable: it is exact for
    ``x + E`` with ``||E||_2 <= eps sqrt(max(m, n)) sigma_1`` (eps =
    2^-24). Wedin's theorem moves the truncation by at most ``||E||_2 (1
    + 2 sigma_1 / (sigma_r - sigma_{r+1}))`` in the 2-norm, and ``sqrt(2r)``
    times that in the Frobenius norm (the difference has rank <= 2r); the
    mean moves by the sample-weighted mean of those. The singular values
    come from a float64 SVD of each client's update. ``sqrt(max(m, n))``
    is a typical size of a Householder SVD's backward error, not its
    worst case: cuSOLVER's ``gesvd`` has shown 2.7 times it on one
    full-width item's singular values (``chip_smoke.py`` check (a)).
    Wedin's worst case leaves the margin: sound runs, card against CPU
    and port against reference, read 0.5-6.2 % of the bound."""
    rank = _uplink_stage(spec, "lora").rank
    eps = 2.0 ** -24
    updates = [train_fn(init, i, 0.05 * (i + 1))(None, spec["rounds"] - 1)
               for i in range(spec["clients"])]
    total = sum(n for _, n, _ in updates)
    out = {}
    for name in names:
        moved = 0.0
        for values, n, _ in updates:
            x = values[name].reshape(-1, values[name].shape[-1]).astype(np.float64)
            s = np.linalg.svd(x, compute_uv=False)
            moved += n / total * math.sqrt(2 * rank) * eps * math.sqrt(max(x.shape)) * s[0] * (
                1 + 2 * s[0] / (s[rank - 1] - s[rank]))
        out[name] = moved / float(np.linalg.norm(np.asarray(want[name], np.float64)))
    return out


def lora_factor_bytes(spec: dict, shapes: dict[str, tuple]) -> tuple[int, list[str]]:
    """Bytes of every factor pair one uplink carries (fp32 ``a`` and
    ``b``: 4 r (m + n) an item), from the shapes alone, and the names of
    the items the ``lora`` stage decomposes."""
    lora = _uplink_stage(spec, "lora")
    names = [n for n, s in shapes.items() if lora._eligible(torch.empty(s, device="meta"))]
    nbytes = sum(4 * lora.rank * (math.prod(shapes[n][:-1]) + shapes[n][-1]) for n in names)
    return nbytes, names


def lora_launches(spec: dict, shapes: dict[str, tuple]) -> dict[str, int]:
    """The launches the lora path implies, from the spec's uplink stack
    and the model's item shapes: the ``lora`` stage decomposes every item
    it finds eligible (no kernel: a library SVD); the ``quantize`` stage
    after it takes the float items left over one at a time (its fused
    group needs it to be the first value stage) — one B4 a leftover item
    an uplink, and one B5 when ``lora-fedavg`` dequantizes it on the
    server. Nothing else launches."""
    fmt = _uplink_stage(spec, "quantize").fmt
    factored = lora_factor_bytes(spec, shapes)[1]
    per_uplink = sum(n not in factored for n in shapes) * (fmt in ("nf4", "fp4"))
    uplinks = spec["clients"] * spec["rounds"]
    return {"quantize_4bit": uplinks * per_uplink, "dequantize_4bit": uplinks * per_uplink}


def envelope_log(pipeline) -> list:
    """Keep every envelope ``pipeline`` frames from now on, as (item
    name, bytes): wraps its per-item encode, the one every streamer
    calls."""
    log: list = []
    encode = pipeline.encode_wire_item_views

    def record(name, value, ctx):
        views = encode(name, value, ctx)
        log.append((name, b"".join(bytes(v) for v in views)))
        return views

    pipeline.encode_wire_item_views = record
    return log


def _envelope(blob: bytes) -> tuple[dict, int]:
    hlen = int.from_bytes(blob[:4], "little")
    return json.loads(blob[4:4 + hlen]), 4 + hlen


def lora_wire_compare(want: list, got: list) -> dict:
    """Two runs' uplink envelope logs (:func:`envelope_log`) from the
    same fixed updates, made by two SVDs (two packages, or card and
    CPU). They must frame the same items in the same order with the same
    body lengths; every envelope without a factor pair must be bitwise
    equal (the nf4 items among them). A factor-pair envelope may differ
    in its factors' bits and, through them, its crc32, whose decimal
    digits are the only part of its length that can differ; so the total
    byte difference must be what those digits explain."""
    bitwise = lowrank = 0
    digit_diff = 0
    same_frames = len(want) == len(got)
    for (wn, wb), (gn, gb) in zip(want, got):
        wh, _ = _envelope(wb)
        gh, _ = _envelope(gb)
        factored = any("r" in vm for vm in wh.get("vm", []))
        same_frames &= wn == gn and wh["n"] == gh["n"] and factored == any(
            "r" in vm for vm in gh.get("vm", []))
        if wb == gb:
            bitwise += 1
        elif factored:
            lowrank += 1
            crc = {name: meta.get("crc") for name, meta in wh["b"]}.get("crc32")
            gcrc = {name: meta.get("crc") for name, meta in gh["b"]}.get("crc32")
            digit_diff += len(str(gcrc)) - len(str(crc))
            same_frames &= {k: v for k, v in wh.items() if k != "b"} == \
                {k: v for k, v in gh.items() if k != "b"}
        else:
            same_frames = False           # a non-factor item that is not bitwise
    byte_diff = sum(len(b) for _, b in got) - sum(len(b) for _, b in want)
    return {"envelopes": len(want), "bitwise": bitwise, "factored_differ": lowrank,
            "byte_diff": byte_diff, "crc_digit_diff": digit_diff,
            "holds": same_frames and byte_diff == digit_diff}


def relative_errors(want: dict, got: dict) -> dict[str, float]:
    """Per item ``||got - want||_F / ||want||_F`` (fp64)."""
    out = {}
    for name, w in want.items():
        w64 = torch.as_tensor(w).double()
        g64 = torch.as_tensor(got[name]).double().to(w64.device)
        out[name] = float((g64 - w64).norm() / w64.norm().clamp_min(1e-300))
    return out
