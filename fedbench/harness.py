"""One run of one cell: set-up, the measured window, the traced readings
and the check.

Set-up builds the federation of the cell's configuration and traffic
through the port's ``repro_torch.fl.job.build_job`` with
round-0 weights the benchmark makes from the seed, and runs its first
round through the window's own call, ``sim.run``; that round is
captured for the check (:mod:`fedbench.capture`) and leaves every shape
warm. The window then runs whole rounds, each fed the last one's global
weights, until ``seconds`` have passed, and lets the last one finish.
Once it has closed and the program's state is freed, the reference
re-derives the first round and :mod:`fedbench.check` decides
``correct``.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Any, Optional

import torch

from fedbench import check, counts, devtrace, hostmem, loader, reference
from fedbench.capture import Capture

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"fedbench: {msg}", file=sys.stderr, flush=True)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files, found by name
    under ``root``: its configuration (the file the entry names) and the
    plain reference that the configuration names, its traffic mix, its
    limits, its configuration's CPU test sizes and its metric readers
    under ``root / "fedbench"``."""

    def __init__(self, root: Path, workload: str) -> None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if workload not in work:
            raise KeyError(f"no workload {workload!r}; known: {sorted(work)}")
        self.workload = work[workload]
        self.name = workload
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        files = root / "fedbench"
        # ``root`` tells the reference's loader which tree to look in
        self.config = {**json.loads((root / conf["file"]).read_text()), "root": str(root)}
        self.reference = reference.load(self.config)
        traffic = self.workload["traffic"]
        self.traffic = json.loads((files / "traffic" / f"{traffic}.json").read_text())
        self.limits = json.loads((files / "limits" / f"{workload}.json").read_text())
        # the CPU tests' sizes: the program's smoke widths of the arch
        self.smoke = json.loads((files / "smoke" / f"{conf['name']}.json").read_text())
        self.chips = int(self.workload["chips"])

        def mine(m: dict[str, Any]) -> bool:
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.metrics_dir = files / "metrics"

    def reader(self, name: str) -> Any:
        return loader.load_file(self.metrics_dir / f"{name}.py", f"fedbench_metric_{name}").read


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def normal_seed(seed: int) -> int:
    """Any whole number as a non-negative 63-bit seed."""
    return seed % (1 << 63)


def model_overrides(cfg: dict[str, Any]) -> dict[str, Any]:
    """The configuration's cut as the program takes it: each key that
    ``reduced`` lists, with the file's value. The program applies
    ``num_layers`` alone, so any other key raises ``ValueError``: a cut
    the program cannot take fails, and never runs uncut."""
    cut = {k: cfg[k] for k in cfg["reduced"]}
    untaken = sorted(set(cut) - {"num_layers"})
    if untaken:
        raise ValueError(f"the cut of {cfg['name']!r} names {untaken}; the program takes "
                         "no cut but num_layers")
    return cut


def job_spec(cell: Cell, cfg: dict[str, Any], seed: int, smoke: bool) -> dict[str, Any]:
    return {**cell.traffic["spec"], "arch": cfg["arch"], "smoke": smoke,
            "num_layers": cfg["num_layers"], "model_overrides": model_overrides(cfg),
            "seed": seed, "rounds": 1}


def setup_round(cell: Cell, cfg: dict[str, Any], seed: int, device: str,
                smoke: bool) -> tuple[Any, dict[str, Any], dict[str, Any]]:
    """Build the federation, run and capture its first round. Returns the
    simulator, the round's global weights and the capture. The round-0
    weights are the reference's; the program checks them against the
    names and shapes of the model it builds, so a cut that does not
    reach the program fails here."""
    from repro_torch.fl.job import build_job

    t0 = time.perf_counter()
    job = build_job(job_spec(cell, cfg, seed, smoke), device=device,
                    weights=cell.reference.make_weights(cfg, seed, device))
    sim, start = job.sim, job.init_weights
    del job
    segs = check.segments(cfg, seed)
    cap = Capture(segs)
    cap.install(sim)
    t1 = time.perf_counter()
    try:
        glob = sim.run(start)
        del start
    finally:
        cap.remove()
    log(f"set-up: weights and build {t1 - t0:.3f} s, first round {time.perf_counter() - t1:.3f} s "
        f"of which capture {cap.seconds:.3f} s")
    return sim, glob, cap.result(glob)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", config: Optional[dict[str, Any]] = None,
             traffic: Optional[dict[str, Any]] = None, smoke: bool = False) -> dict[str, Any]:
    """One run; returns the contract's result object. ``config`` and
    ``traffic`` replace the cell's (the CPU tests' small sizes, with
    ``smoke`` building the program's smoke model of the same arch)."""
    from repro_torch.obs import Tracer
    from repro_torch.utils.mem import MemoryMeter

    seed = normal_seed(seed)
    cell = Cell(root, workload)
    if traffic is not None:
        cell.traffic = traffic
    cfg = config or cell.config
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sampler = hostmem.HostSampler()
    try:
        sim, glob, prog = setup_round(cell, cfg, seed, device, smoke)
        sync()
        sim.meter = MemoryMeter()       # the window's own high-water mark
        dtrace = None
        if trace:
            sim.tracer = Tracer(capacity=1 << 20)    # spans without device syncs
            dtrace = devtrace.DeviceTrace(sim.tracer)
        gc.collect()
        rss0 = sampler.reset()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
            blocks0 = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
        if dtrace is not None:
            dtrace.open()
        setup_s = process_age_s()
        t0 = time.perf_counter()
        ends: list[float] = []
        while not ends or ends[-1] < seconds:   # whole rounds; the last one finishes
            glob = sim.run(glob)
            sync()
            ends.append(time.perf_counter() - t0)
        window_s, rounds = ends[-1], len(ends)
        reading = dtrace.close(window_s) if dtrace is not None else None
        window_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        host_peak = sampler.stop()
    finally:
        sampler.close()
    log(f"window {window_s:.3f} s, {rounds} rounds ending at {[round(t, 3) for t in ends]}")
    log(f"host: RSS {rss0} B at the window's start, {host_peak} B at its peak")
    if on_cuda:     # page-locked host blocks, and how many the window made
        held = torch.cuda.host_memory_stats()
        log(f"page-locked host memory: {held.get('allocated_bytes.current', 0)} B in "
            f"{held.get('num_host_alloc', 0)} blocks, {held.get('num_host_alloc', 0) - blocks0} "
            "made in the window")
    meter_peak = sim.meter.peak
    del sim, glob
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    result: dict[str, Any] = {"correct": False,
                              "attempted": rounds * cell.traffic["spec"]["clients"],
                              "failed": 0, "metrics": {}}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if reading is None:
        e2e = {"round_s": window_s / rounds, "peak_device_gb": window_peak / 1e9,
               "peak_host_rss_gb": host_peak / 1e9, "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": units[m["name"]]}
    else:
        fmt_down, fmt_up = check.wire_formats(cell.traffic)
        card = torch.cuda.get_device_name(0) if on_cuda else "cpu"
        # what a per-layer metric's reader reads
        r = types.SimpleNamespace(
            trace=reading, rounds=rounds, round_s=window_s / rounds, window_s=window_s,
            meter_peak_bytes=meter_peak, peaks=counts.PEAKS.get(card),
            flops_per_round=counts.flops_per_round(cfg, cell.traffic),
            codec_bytes_per_round=counts.codec_bytes_per_round(cfg, cell.traffic,
                                                               fmt_down, fmt_up))
        for m in cell.per_layer:
            value = cell.reader(m["name"])(r)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
    result["device"] = device_info(on_cuda, cell.chips, window_peak)
    if reading is not None:
        result["device"].update(busy_s=reading.busy_s(), window_s=window_s)
        result["breakdown"] = {"device_ops": reading.device_ops(),
                               "idle_gaps": reading.idle_gaps()}
        log(f"traced spans a round: {reading.span_rounds()}")

    t_ref = time.perf_counter()
    ref = check.reference_round(cfg, cell.traffic, seed, check.segments(cfg, seed), device)
    ok, checks = check.judge(check.numbers(prog, ref, cell.traffic), cell.limits)
    log(f"reference {time.perf_counter() - t_ref:.3f} s; "
        f"losses {[c['losses'] for c in ref['clients']]}")
    result["correct"] = ok
    result["checks"] = checks
    return result


def device_info(on_cuda: bool, chips: int, peak: int) -> dict[str, Any]:
    if not on_cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w()}
