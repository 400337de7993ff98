"""The comparison that decides ``correct``.

What the program produced in the set-up round (the federation's first
round, driven through the window's own call and captured at the layer
boundaries by :mod:`fedbench.capture`) is held against the plain
reference of :mod:`fedbench.reference`, which re-derives the round from
the benchmark's own inputs (the weights and the token stream from the
seed) and never reads the program's state but to judge it:

``downlink_mismatch``  sampled decoded downlink values that differ from
                       the reference's codec round trip of the seed's
                       weights (every client; exact, limit 0).
``loss_gap``           each client's last local-step loss against the
                       reference's, relative; the worst client.
``change_gap``         each leaf's norm of the change its client's local
                       steps made, against the reference's: the gap over
                       the larger of the reference's norm of that leaf
                       and of the median leaf; the worst leaf of the
                       worst client. Leaves whose step-1 gradient is
                       under a thousandth of the median leaf's are left
                       out (rounding moves them under AdamW).
``uplink_mismatch``    sampled uplink codes (or, where the server
                       decodes them, decoded values) that differ from the
                       reference's encoding of the program's own trained
                       weights at the same places (exact, limit 0).
``fold_gap``           the new global weights against the reference's
                       float64 weighted mean of the uplinks the server
                       received, at the sampled places: the largest gap
                       over the leaf's largest value; the worst leaf.

Samples are whole 4096-element segments of each flattened leaf, drawn
from the seed: the first, the last (with its padding) and up to 14 more.
The training numbers follow the reference's own training from its own
decoded downlink; the uplink and the fold are judged from the program's
trained weights and received codes, stage by stage.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Optional

import numpy as np
import torch

from fedbench import reference
from fedbench.reference import codec, local

SEGMENT = 4096
EXTRA_SEGMENTS = 14
NAMES = ("downlink_mismatch", "loss_gap", "change_gap", "uplink_mismatch", "fold_gap")
#: leaves whose reference step-1 gradient norm is under this share of
#: the median leaf's are left out of ``change_gap``
GRAD_FLOOR = 1e-3
#: every number's reading where the program's output is missing or
#: misshapen (a client, an item, a segment): above any limit, and finite
MISSING = 1e30


def wire_formats(traffic: dict[str, Any]) -> tuple[str, str]:
    """The quantize stage of each hop in the traffic's job spec."""
    pipe = traffic["spec"]["pipeline"]

    def fmt(hop: str) -> str:
        for stage in pipe.get(hop, []):
            if isinstance(stage, str) and stage.startswith("quantize:"):
                return stage.split(":", 1)[1]
        raise ValueError(f"traffic {traffic['name']!r} has no quantize stage on {hop}")

    return fmt("task_data_out"), fmt("task_result_out")


def segments(cfg: dict[str, Any], seed: int) -> dict[str, list[int]]:
    """Each leaf's sampled segment indices, drawn from the seed."""
    out = {}
    for i, (name, (shape, _)) in enumerate(reference.load(cfg).param_specs(cfg).items()):
        nseg = math.ceil(math.prod(shape) / SEGMENT)
        rng = np.random.default_rng((seed, i))
        pick = rng.choice(nseg, size=min(EXTRA_SEGMENTS, nseg), replace=False)
        out[name] = sorted({0, nseg - 1, *(int(s) for s in pick)})
    return out


def segment_range(n: int, s: int) -> tuple[int, int]:
    return s * SEGMENT, min(n, (s + 1) * SEGMENT)


def sample_values(t: torch.Tensor, segs: list[int]) -> list[torch.Tensor]:
    """The float32 elements of each segment of a tensor, on the CPU."""
    flat = t.detach().reshape(-1)
    return [flat[a:b].to(device="cpu", dtype=torch.float32, copy=True)
            for a, b in (segment_range(flat.numel(), s) for s in segs)]


def sample_codes(payload: Any, absmax: Any, n: int, fmt: str,
                 segs: list[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each segment's codes and absmax from a wire item of ``n`` elements:
    its flat payload bytes and per-block scales."""
    codes = torch.as_tensor(np.asarray(payload) if not isinstance(payload, torch.Tensor)
                            else payload).reshape(-1)
    scales = torch.as_tensor(np.asarray(absmax) if not isinstance(absmax, torch.Tensor)
                             else absmax).reshape(-1)
    block = codec.BLOCK[fmt]
    per_block = block if fmt == "blockwise8" else block // 2
    out = []
    for s in segs:
        a, b = segment_range(n, s)
        b0, b1 = a // block, math.ceil(b / block)
        out.append((codes[b0 * per_block:b1 * per_block].cpu().clone(),
                    scales[b0:b1].cpu().clone()))
    return out


def _mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.is_floating_point():
        differ = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    else:
        differ = a != b
    return int(differ.sum())


def reference_round(cfg: dict[str, Any], traffic: dict[str, Any], seed: int,
                    segs: dict[str, list[int]], device: Any,
                    precision: str = "fp32", rows: Optional[int] = None) -> dict[str, Any]:
    """The reference's round from the seed: its decoded downlink (sampled),
    and per client the last loss, each leaf's change norm and step-1
    gradient norm, and its trained weights (sampled). Run leaf by leaf
    where it can, one client's training state at a time."""
    fmt_down, _ = wire_formats(traffic)
    tr = traffic["spec"]
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products, as stated
    torch.backends.cudnn.allow_tf32 = False
    w0 = reference.load(cfg).make_weights(cfg, seed, device)
    start = {n: codec.roundtrip(w.reshape(-1), fmt_down).view(w.shape) for n, w in w0.items()}
    del w0
    out: dict[str, Any] = {"start": {n: sample_values(t, segs[n]) for n, t in start.items()},
                           "clients": []}
    for mode in local.client_modes(tr, seed):
        r = local.train_client(start, cfg, tr, seed, mode, precision, rows)
        p = r["params"]
        out["clients"].append({
            "loss": r["losses"][-1],
            "losses": r["losses"],
            "first_grad_norm": r["first_grad_norm"],
            "change_norm": {n: float(torch.linalg.vector_norm(p[n] - start[n],
                                                              dtype=torch.float64))
                            for n in p},
            "trained": {n: sample_values(p[n], segs[n]) for n in p},
        })
        del r, p
    return out


def as_program(ref: dict[str, Any], traffic: dict[str, Any]) -> dict[str, Any]:
    """A reference round dressed as the program's capture: its uplink
    encoded from its trained samples and its fold rounded to float32.
    Run on the control (the reference in a lower precision), this puts
    the control in the program's place."""
    _, fmt_up = wire_formats(traffic)
    consumes_codes = traffic["spec"]["aggregator"] == "quantized-fedavg"
    clients = []
    for c in ref["clients"]:
        up = {n: [_wire_item(v, fmt_up, consumes_codes) for v in parts]
              for n, parts in c["trained"].items()}
        clients.append({"start": ref["start"], "trained": c["trained"], "loss": c["loss"],
                        "change_norm": c["change_norm"], "uplink": up})
    weights = [1.0] * len(clients)      # every client trains as many rows
    glob = {n: [codec.fold([_decoded(cl["uplink"][n][i], fmt_up, len(seg)) for cl in clients],
                           weights).float()
                for i, seg in enumerate(parts)]
            for n, parts in ref["start"].items()}
    return {"clients": clients, "global": glob}


def _wire_item(values: torch.Tensor, fmt: str, codes: bool) -> Any:
    """A sampled segment as the server receives it: codes and scales, or
    decoded values."""
    if not codes:
        return codec.roundtrip(values, fmt)
    q, absmax = codec.encode(codec.blocks(values, fmt), fmt)
    return q.reshape(-1), absmax


def _decoded(item: Any, fmt: str, n: int) -> torch.Tensor:
    """One sampled uplink segment as float32 values (``n`` of them)."""
    if isinstance(item, tuple):
        codes, absmax = item
        per_block = codec.BLOCK[fmt] if fmt == "blockwise8" else codec.BLOCK[fmt] // 2
        return codec.decode(codes.view(-1, per_block), absmax, fmt).reshape(-1)[:n]
    return item


def numbers(prog: dict[str, Any], ref: dict[str, Any],
            traffic: dict[str, Any]) -> dict[str, float]:
    """The compared numbers of one round: the program's capture (or a
    control dressed as one) against the reference round; every one reads
    :data:`MISSING` where the program's output lacks a part."""
    _, fmt_up = wire_formats(traffic)
    tr = traffic["spec"]
    try:
        return _numbers(prog, ref, fmt_up, float(tr["batch"] * tr["local_steps"]))
    except (KeyError, IndexError, ValueError, RuntimeError):
        return dict.fromkeys(NAMES, MISSING)


def _numbers(prog: dict[str, Any], ref: dict[str, Any], fmt_up: str,
             weight: float) -> dict[str, float]:
    if len(prog["clients"]) != len(ref["clients"]):
        raise ValueError(f"{len(prog['clients'])} clients trained, not {len(ref['clients'])}")
    down = up = 0
    loss_gap = change_gap = 0.0
    for pc, rc in zip(prog["clients"], ref["clients"]):
        for n, parts in ref["start"].items():
            down += sum(_mismatches(a, b) for a, b in zip(pc["start"][n], parts))
        loss_gap = max(loss_gap, abs(pc["loss"] - rc["loss"]) / abs(rc["loss"]))
        grads = rc["first_grad_norm"]
        floor = GRAD_FLOOR * statistics.median(grads.values())
        kept = [n for n in rc["change_norm"] if grads[n] >= floor]
        med = statistics.median(rc["change_norm"][n] for n in kept)
        for n in kept:
            want = rc["change_norm"][n]
            change_gap = max(change_gap, abs(pc["change_norm"][n] - want) / max(want, med))
        for n, parts in pc["trained"].items():
            for got, values in zip(pc["uplink"][n], parts):
                if isinstance(got, tuple):
                    q, a = codec.encode(codec.blocks(values, fmt_up), fmt_up)
                    up += _mismatches(got[0], q.reshape(-1)) + _mismatches(got[1], a)
                else:
                    up += _mismatches(got, codec.roundtrip(values, fmt_up))
    fold_gap = 0.0
    for n, parts in prog["global"].items():
        top = diff = 0.0
        for i, got in enumerate(parts):
            want = codec.fold([_decoded(pc["uplink"][n][i], fmt_up, got.numel())
                               for pc in prog["clients"]],
                              [weight] * len(prog["clients"]))
            if want.shape != got.shape:
                raise ValueError(f"{n}: a segment of {got.numel()} values, not {want.numel()}")
            top = max(top, float(want.abs().max()))
            diff = max(diff, float((got.double() - want).abs().max()))
        fold_gap = max(fold_gap, diff / max(top, codec.FLT_MIN))
    return {"downlink_mismatch": float(down), "loss_gap": loss_gap, "change_gap": change_gap,
            "uplink_mismatch": float(up), "fold_gap": fold_gap}


def judge(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, Any]]:
    """``correct`` and each number beside its limit: a number passes when
    it is at most its limit (a NaN never passes)."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NAMES}
    ok = all(values[n] <= limits[n] for n in NAMES)
    return ok, checks


def describe(checks: dict[str, Any]) -> list[str]:
    return [f"check {n}: {c['value']!r} limit {c['limit']!r}" for n, c in checks.items()]

