"""Small sizes of the benchmark's cells for the CPU tests: each
configuration at the port's smoke widths of its arch (the sizes in
``fedbench/smoke/<configuration>.json``), and each traffic mix with
fewer local steps and shorter rows."""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any

from fedbench import harness
from fedbench.reference import local

ROOT = Path(__file__).resolve().parents[2]
#: every workload of ``BENCHMARK.json``, in the file's order
CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


def small(workload: str, local_steps: int = 2, seq: int = 32,
          root: Path = ROOT) -> tuple[dict, dict]:
    """The cell's configuration at smoke widths and its traffic cut down."""
    cell = harness.Cell(root, workload)
    cfg = {**cell.config, **cell.smoke}
    traffic = copy.deepcopy(cell.traffic)
    traffic["spec"].update(local_steps=local_steps, seq=seq)
    return cfg, traffic


def distinct_clients_seed(traffic: dict[str, Any], start: int = 1) -> int:
    """A seed whose clients draw from different modes of the corpus."""
    seed = start
    while len({m for m in local.client_modes(traffic["spec"], seed)}) < 2:
        seed += 1
    return seed


def run(workload: str, seed: int, trace: bool = False, root: Path = ROOT,
        **sizes: Any) -> dict:
    cfg, traffic = small(workload, root=root, **sizes)
    return harness.run_cell(root, workload, seed, 0.0, trace, device="cpu", config=cfg,
                            traffic=traffic, smoke=True)
