"""Small sizes of the benchmark's cells for the CPU tests: each
configuration at the port's smoke widths (its ``SMOKE_OVERRIDES``), and
each traffic mix with fewer local steps and shorter rows."""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any

from fedbench import harness
from fedbench.reference import local

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("stablelm-b8-stream", "granite6-nf4-train")
SMOKE = {
    "stablelm-b8-stream": dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
                               d_ff=512, vocab_size=512, head_dim=64),
    "granite6-nf4-train": dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                               d_ff=512, vocab_size=512, head_dim=64),
}


def small(workload: str, local_steps: int = 2, seq: int = 32) -> tuple[dict, dict]:
    """The cell's configuration at smoke widths and its traffic cut down."""
    cell = harness.Cell(ROOT, workload)
    cfg = {**cell.config, **SMOKE[workload]}
    traffic = copy.deepcopy(cell.traffic)
    traffic["spec"].update(local_steps=local_steps, seq=seq)
    return cfg, traffic


def distinct_clients_seed(traffic: dict[str, Any], start: int = 1) -> int:
    """A seed whose clients draw from different modes of the corpus."""
    seed = start
    while len({m for m in local.client_modes(traffic["spec"], seed)}) < 2:
        seed += 1
    return seed


def run(workload: str, seed: int, trace: bool = False, **sizes: Any) -> dict:
    cfg, traffic = small(workload, **sizes)
    return harness.run_cell(ROOT, workload, seed, 0.0, trace, device="cpu", config=cfg,
                            traffic=traffic, smoke=True)
