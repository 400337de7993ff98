"""Readings that set the check's limits, on the card, for one cell:

    python fedbench/readings.py --workload NAME --seeds 1,2,3 --faults 1,2 [--out FILE]

For every seed of ``--seeds`` the program's first round (the set-up
round of a run: the same entry, sizes and capture) is held against the
reference, as a run's check does. For every seed of ``--faults``, also
the control and the faults, each put in the program's place:

``control_tf32``   the reference with every matrix product in TF32
``half_batch``     the reference training on half of each batch
``unchanged``      local steps that leave the weights as they came
``client_dropped`` the fold leaves the second client out
``code_altered``   one uplink code of the first client changed where it
                   is produced

and ``ref_as_program``, the reference against itself. One JSON line a
seed. The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def faults(ref, cfg, traffic, segs, seed, device):
    """The numbers of the control and of each fault, put in the program's
    place, against the reference round ``ref``."""
    from fedbench import check

    out = {}
    base = check.as_program(ref, traffic)
    out["ref_as_program"] = check.numbers(base, ref, traffic)
    tf = check.reference_round(cfg, traffic, seed, segs, device, precision="tf32")
    out["control_tf32"] = check.numbers(check.as_program(tf, traffic), ref, traffic)
    del tf
    half = check.reference_round(cfg, traffic, seed, segs, device,
                                 rows=traffic["spec"]["batch"] // 2)
    out["half_batch"] = check.numbers(check.as_program(half, traffic), ref, traffic)
    del half
    same = copy.deepcopy(ref)
    for c in same["clients"]:
        c["change_norm"] = {n: 0.0 for n in c["change_norm"]}
        c["trained"] = copy.deepcopy(same["start"])
    out["unchanged"] = check.numbers(check.as_program(same, traffic), ref, traffic)
    one = check.as_program(ref, traffic)
    dropped = copy.deepcopy(ref)
    dropped["clients"] = dropped["clients"][:1]
    one["global"] = check.as_program(dropped, traffic)["global"]
    out["client_dropped"] = check.numbers(one, ref, traffic)
    alt = copy.deepcopy(ref)
    name = sorted(alt["clients"][0]["trained"])[0]
    seg = alt["clients"][0]["trained"][name][0]
    seg[0] = seg[0] + seg.abs().max() * 0.05 + 1e-3
    moved = check.as_program(alt, traffic)
    moved["clients"][0]["trained"] = ref["clients"][0]["trained"]
    out["code_altered"] = check.numbers(moved, ref, traffic)
    return out


def seed_row(cell, cfg, seed: int, with_faults: bool, device: str = "cuda",
             smoke: bool = False) -> dict:
    """One seed's readings: the program's, and with ``with_faults`` the
    control's and the faults'."""
    import torch

    from fedbench import check, harness

    t0 = time.perf_counter()
    sim, glob, prog = harness.setup_round(cell, cfg, seed, device, smoke)
    del sim, glob
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    segs = check.segments(cfg, seed)
    ref = check.reference_round(cfg, cell.traffic, seed, segs, device)
    row = {"seed": seed, "program": check.numbers(prog, ref, cell.traffic),
           "losses": [c["losses"] for c in ref["clients"]]}
    if with_faults:
        row.update(faults(ref, cfg, cell.traffic, segs, seed, device))
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fedbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from fedbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(ROOT, args.workload)
    fault_seeds = {int(s) for s in args.faults.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            row = seed_row(cell, cell.config, seed, seed in fault_seeds)
            line = json.dumps(row)
            print(line, flush=True)
            if sink is not None:
                sink.write(line + "\n")
                sink.flush()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
