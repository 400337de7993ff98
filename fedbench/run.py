"""The port's benchmark: one run of one cell on the card.

    python fedbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. It refuses to run without a CUDA
device (or with fewer than the cell asks for) and prints no result
then. With ``--trace 0`` the result holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and the traced device readings.
The numbers that decide ``correct`` close standard error, each beside
its limit, and the result's ``checks`` key. The last line of standard
output is the result, one JSON object.

Build and compiler caches stay inside the checkout, at fixed paths
under ``build/``: the port's CUDA library in
``build/repro_torch_kernels`` and, should anything use them,
``build/triton`` and ``build/torch_extensions``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _prepare_environment() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fedbench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_environment()

    import torch

    from fedbench import check, harness

    chips = harness.Cell(ROOT, args.workload).chips
    if not torch.cuda.is_available():
        print("fedbench: no CUDA device; the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"fedbench: the cell needs {chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"fedbench: the process holds {found}; the benchmark runs without JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for line in check.describe(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
