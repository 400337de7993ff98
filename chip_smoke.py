#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out report.json]

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc, holds each one against its plain PyTorch version on the card at
the main path's shapes (timing both: quantize over one message's fused
group, dequantize and the fold over the largest item), then drives one
full-width llama3.2-1b federated round through ``repro_torch.fl.job`` —
blockwise8 downlink, two clients each taking two AdamW steps, blockwise8
+ crc32 uplink, streaming int8 fold — and checks that every kernel of that path
launched, that losses and weights are finite, and that a smoke-width
federation on the card agrees with the same federation on the CPU.

Output: the card, build and per-kernel lines, per-phase wall times, then
the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``. Exits non-zero (and
prints no result) on any failure, without CUDA, or outside a checkout.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: the slice: examples/jobs/live_smoke.json at full width, quantized
#: downlink, int8 fold aggregator
SPEC = {
    "arch": "llama3.2-1b", "smoke": False, "rounds": 1, "clients": 2,
    "local_steps": 2, "batch": 4, "seq": 32, "partition": "iid",
    "pipeline": {"task_data_out": ["quantize:blockwise8"],
                 "task_result_out": ["quantize:blockwise8", "crc32"]},
    "aggregator": "quantized-fedavg", "server_streaming_agg": True,
    "transmission": "container", "driver": "loopback", "chunk_mb": 1, "seed": 0,
}
N_ITEMS = 12                       # flat state-dict items of llama3.2-1b
LARGEST_ITEM = (16, 2048, 8192)    # blocks.mlp.w_gate / w_up
GROUP_BLOCKS = 365_841             # 4096-blocks of one message's fused group

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12             # fp32 outside the tensor cores

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/blockwise8.cu"
REPLACES = {
    "quantize_blockwise8": "src/repro/kernels/quant_blockwise8.py:45",
    "dequantize_blockwise8": "src/repro/kernels/quant_blockwise8.py:66",
    "dequant_accumulate8_into": "src/repro/kernels/fused_dequant_agg.py:85",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM rate and fp32
    operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def bits(torch, t):
    return t.contiguous().view(torch.int32)


def check_kernels(torch, dev) -> dict[str, dict]:
    """Every kernel against its plain version on the card, each at the
    shapes the main path gives it: the edge cases of
    ``repro_torch.kernels.cases``; the slice's largest item for all three
    (dequantize and the fold run per item); and the whole fused group of
    one message (365,841 blocks of the slice's own initial weights) for
    quantize, which runs once per message over all of it. Quantize is
    timed at the fused group, dequantize and the fold at the largest item."""
    from repro_torch.core.quantization import pack_blockwise8_group
    from repro_torch.fl.job import initial_weights
    from repro_torch.kernels import cases, ops, ref
    from repro_torch.kernels.fused_dequant_agg import dequant_accumulate8_into
    from repro_torch.kernels.quant_blockwise8 import (
        dequantize_blockwise8,
        quantize_blockwise8,
    )

    err = {name: 0.0 for name in REPLACES}

    def compare_quantize(name, x2d):
        q, am = quantize_blockwise8(x2d)
        q_p, am_p = ref.quantize_blockwise8(x2d)
        if not (torch.equal(q, q_p) and torch.equal(bits(torch, am), bits(torch, am_p))):
            fail(f"quantize kernel disagrees with its plain version on {name}")
        return q, am

    def compare(name, x2d, acc0, weight):
        q, am = compare_quantize(name, x2d)
        d = dequantize_blockwise8(q, am)
        d_p = ref.dequantize_blockwise8(q, am)
        if not torch.equal(bits(torch, d), bits(torch, d_p)):
            fail(f"dequantize kernel disagrees with its plain version on {name}")
        del d, d_p
        k = dequant_accumulate8_into(acc0.clone(), q, am, weight)
        p = ref.dequant_accumulate8_into(acc0.clone(), q, am, weight)
        diff = (k - p).abs()
        ulp = torch.nextafter(p.abs(), torch.full_like(p, math.inf)) - p.abs()
        if bool((diff > ulp).any()):
            fail(f"fold kernel differs from its plain version by more than 1 ulp of "
                 f"|acc| on {name} (weight {weight})")
        err["dequant_accumulate8_into"] = max(err["dequant_accumulate8_into"],
                                              float(diff.max()))
        return q, am

    for name, x in cases.blockwise8_cases().items():
        x2d = ops.pad_to_blocks(torch.from_numpy(x).to(dev))
        for w in cases.FOLD_WEIGHTS:
            acc0 = torch.from_numpy(cases.fold_accumulator(x2d.shape[0])).to(dev)
            compare(name, x2d, acc0, w)
    print(f"kernels agree with their plain versions on {len(cases.blockwise8_cases())} "
          "edge cases (quantize, dequantize bitwise; fold within 1 ulp of |acc|)")

    rows = {}

    def time_rows(timed, n):
        for name, (kern, plain, lib, nbytes, nops) in timed.items():
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, plain, reps=10, warmup=1)
            lib_ms = time_ms(torch, lib) if lib is not None else None
            bound_ms, bound_by = bound(nbytes, nops)
            rows[name] = {"elements": n, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "max_abs_err": err[name]}
            print(f"{name}: {ms:.4f} ms at {n} elements ({nbytes / ms / 1e6:.1f} GB/s), "
                  f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% of it), "
                  f"plain {plain_ms:.4f} ms, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")

    # the slice's largest item, weight-like values
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = math.prod(LARGEST_ITEM)
    x2d = (torch.randn(n, generator=gen, device=dev) * 0.02).reshape(-1, ref.BLOCK8)
    acc0 = torch.randn(x2d.shape, generator=gen, device=dev) * 0.02
    weight = float(SPEC["batch"] * SPEC["local_steps"])
    q, am = compare("blocks.mlp.w_gate", x2d, acc0, weight)
    del x2d
    torch.cuda.synchronize()

    nb = q.shape[0]
    scale = am * ref.INV127
    s_fold = am * float(np.float32(ref.INV127) * np.float32(weight))
    acc_k, acc_p, acc_l = acc0.clone(), acc0.clone(), acc0.clone()
    del acc0
    time_rows({
        "dequantize_blockwise8": (
            lambda: dequantize_blockwise8(q, am), lambda: ref.dequantize_blockwise8(q, am),
            lambda: q.float() * scale[:, None],
            5 * n + 4 * nb, 2 * n),
        "dequant_accumulate8_into": (
            lambda: dequant_accumulate8_into(acc_k, q, am, weight),
            lambda: ref.dequant_accumulate8_into(acc_p, q, am, weight),
            lambda: acc_l.addcmul_(q, s_fold[:, None]),
            9 * n + 4 * nb, 3 * n),
    }, n)
    del q, am, scale, s_fold, acc_k, acc_p, acc_l
    torch.cuda.empty_cache()

    # one message's fused group, laid out as quantize_batch lays it out
    weights = initial_weights(SPEC, device=dev)
    x2d, _spans = pack_blockwise8_group(weights, list(weights), dev)
    del weights
    if x2d.shape[0] != GROUP_BLOCKS:
        fail(f"fused group has {x2d.shape[0]} blocks, expected {GROUP_BLOCKS}")
    q, am = compare_quantize("the fused group", x2d)
    del q, am
    torch.cuda.empty_cache()
    n = x2d.numel()
    print(f"quantize kernel agrees bitwise with its plain version on the fused group "
          f"({GROUP_BLOCKS} blocks, {n} elements)")
    time_rows({
        "quantize_blockwise8": (
            lambda: quantize_blockwise8(x2d), lambda: ref.quantize_blockwise8(x2d), None,
            5 * n + 4 * GROUP_BLOCKS, 6 * n),
    }, n)
    del x2d
    torch.cuda.empty_cache()
    return rows


def phase_times(events: list[dict]) -> dict[str, float]:
    """Per-phase wall seconds from the device-synchronised span trace.
    A transmit span holds the encode and the receiving end's decode or
    fold of that message, plus the host framing (serialization, crc32,
    chunking, reassembly); local steps run between the two transmits."""
    spans = [e for e in events if e.get("ph") == "X"]
    transmits = [e for e in spans if e["name"] == "wire.transmit"]

    def direction(e):
        for t in transmits:
            if t["ts"] <= e["ts"] and e["ts"] + e["dur"] <= t["ts"] + t["dur"]:
                return t["args"]["kind"]
        return None

    def total(pred):
        return sum(e["dur"] for e in spans if pred(e)) / 1e6

    return {
        "downlink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                     and e["args"]["kind"] == "task_data"),
        "uplink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                   and e["args"]["kind"] == "task_result"),
        "downlink_encode_s": total(lambda e: e["name"] == "kernel.quantize_batch"
                                   and direction(e) == "task_data"),
        "client_decode_s": total(lambda e: e["name"] == "stage.decode.quantize"),
        "local_steps_s": total(lambda e: e["name"] == "client.train"),
        "uplink_encode_s": total(lambda e: e["name"] == "kernel.quantize_batch"
                                 and direction(e) == "task_result"),
        "fold_s": total(lambda e: e["name"] == "kernel.dequant_accumulate8"),
        "finish_s": total(lambda e: e["name"] == "agg.finish"),
    }


def run_slice(torch, dev) -> dict:
    """The main path: one full-width federated round, counters read."""
    from repro_torch.fl.job import build_job
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    job = build_job({**SPEC, "trace": True}, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    result = job.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    clients, rounds = SPEC["clients"], SPEC["rounds"]
    want = {"quantize_blockwise8": 2 * clients * rounds,
            "dequantize_blockwise8": clients * rounds * N_ITEMS,
            "dequant_accumulate8_into": clients * rounds * N_ITEMS}
    print(f"slice launches: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launches on the main path {launches} != {want}")
    losses = result["history"]
    if len(losses) != clients * rounds or not all(math.isfinite(x) for x in losses):
        fail(f"losses not finite: {losses}")
    final, init = result["final_weights"], job.init_weights
    if list(final) != list(init) or len(final) != N_ITEMS:
        fail("final weights do not have the initial weights' names")
    moved = 0
    for name, w in final.items():
        if w.shape != init[name].shape or w.device.type != dev.type:
            fail(f"{name}: shape {tuple(w.shape)} on {w.device}")
        if not bool(torch.isfinite(w).all()):
            fail(f"{name}: non-finite final weights")
        moved += int(not torch.equal(w, init[name]))
    if moved != len(final):
        fail(f"only {moved} of {len(final)} tensors moved from their initial values")
    n_params = sum(w.numel() for w in final.values())
    phases = phase_times(job.sim.tracer.chrome_trace()["traceEvents"])
    report = {
        "wall_s": wall, "build_job_s": build_s,
        "round_wall_s": [r["wall_s"] for r in result["round_log"]],
        "phases": phases, "losses": losses, "launches": launches,
        "messages": result["messages"], "wire_bytes": result["wire_bytes"],
        "params": n_params,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    print(f"slice: {n_params} params, {result['messages']} messages, "
          f"{result['wire_bytes']} wire bytes, losses {losses}, wall {wall:.3f} s "
          f"(build_job {build_s:.3f} s)")
    print("phases (s): " + ", ".join(f"{k}={v:.4f}" for k, v in phases.items()))
    print(f"max_memory_allocated: {report['max_memory_allocated_bytes']} bytes")
    del job, result, final, init
    torch.cuda.empty_cache()
    return report


def check_against_cpu(torch, dev) -> dict:
    """Smoke width, card vs CPU from identical weights: fixed updates must
    give the same bits; a trained round must agree within one
    quantization step per block plus 1e-5 relative (see
    tests/test_torch_slice.py for why)."""
    from repro_torch.fl.job import build_job, initial_weights, run_job
    from repro_torch.kernels.ref import BLOCK8

    spec = {**SPEC, "smoke": True, "rounds": 1}
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}

    def fixed(index):
        def train_fn(_params, rnd):
            rng = np.random.default_rng((index, rnd))
            return ({k: v + rng.standard_normal(v.shape).astype(np.float32) * np.float32(0.05)
                     for k, v in init.items()}, 3 + 5 * index, {})
        return train_fn

    outs = {}
    for d in ("cpu", dev):
        jb = build_job(spec, device=d, weights=init)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = fixed(i)
        outs[str(d)] = {k: v.cpu() for k, v in jb.run()["final_weights"].items()}
    for name, want in outs["cpu"].items():
        if not torch.equal(bits(torch, outs[str(dev)][name]), bits(torch, want)):
            fail(f"fixed-update federation differs between card and CPU at {name}")

    cpu = run_job(spec, device="cpu", weights=init)
    gpu = run_job(spec, device=dev, weights=init)
    worst = 0.0
    for name, want in cpu["final_weights"].items():
        got = gpu["final_weights"][name].cpu()
        flat_w, flat_g = want.reshape(-1).abs(), got.reshape(-1).abs()
        pad = -flat_w.numel() % BLOCK8
        am = torch.maximum(torch.nn.functional.pad(flat_w, (0, pad)),
                           torch.nn.functional.pad(flat_g, (0, pad)))
        step = am.reshape(-1, BLOCK8).amax(1).repeat_interleave(BLOCK8)[:flat_w.numel()] / 127
        err = (got - want).abs().reshape(-1)
        if bool((err > step + 1e-5 * want.abs().reshape(-1)).any()):
            fail(f"trained round on the card is more than one quantization step from "
                 f"the CPU at {name}")
        worst = max(worst, float((err / step.clamp_min(1e-30)).max()))
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["history"], cpu["history"]))
    if rel > 1e-4:
        fail(f"losses on the card differ from the CPU by {rel:.3g} relative")
    print(f"smoke width, card vs CPU: fixed-update weights bitwise equal; trained round "
          f"within {worst:.3f} quantization steps, losses within {rel:.3g} relative")
    return {"trained_max_steps": worst, "loss_rel": rel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import _build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32: off for matmul and cuDNN")

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda")
    rows = check_kernels(torch, dev)
    slice_report = run_slice(torch, dev)
    parity = check_against_cpu(torch, dev)

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": slice_report["launches"][name],
         **rows[name]}
        for name in REPLACES
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "kernels": kernels, "slice": slice_report,
                       "cpu_parity": parity}, fh, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
