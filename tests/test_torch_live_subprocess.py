"""Port, the live plane end to end: ``python -m
repro_torch.launch.federation`` on ``examples/jobs/live_smoke.json`` at
smoke width, 2 clients, 1 round, ``--device cpu --verify-sim``. The
server spawns its clients as subprocesses that train llama3.2-1b (smoke
width) with the port's autograd, stream over real TCP, and fold in
grant order; ``--verify-sim`` runs the port's ``run_job`` on the same
spec and fails unless the final weights are bitwise-equal.

Every process runs one intra-op thread (``OMP_NUM_THREADS=1`` through
the environment, which the spawned clients inherit): the CPU matmuls of
the clients and of the server's ``run_job`` then sum in one order, and
the suite's workers do not oversubscribe the host. The join timeout is
generous, since each client imports torch and builds its model first.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_subprocess_federation_bitwise_matches_run_job(tmp_path):
    out = tmp_path / "summary.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.federation",
         "--spec", str(ROOT / "examples" / "jobs" / "live_smoke.json"),
         "--clients", "2", "--rounds", "1", "--device", "cpu",
         "--join-timeout", "600", "--verify-sim", "--json", str(out)],
        capture_output=True, text=True, timeout=900, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(out.read_text())
    assert summary["sim_bitwise_equal"] is True
    assert summary["client_exit_codes"] == [0, 0]
    assert [r["clients"] for r in summary["round_log"]] == [["site-0", "site-1"]]
    assert summary["restarts"] == 0 and summary["bytes_up"] > 0
