"""A cell enters by new files alone. In a copy of the benchmark's files,
a third workload whose configuration names a reference of its own runs
through the harness on the CPU and is judged by that reference, which
also makes its weights, its segments and the yardstick's counts. A
reference path outside ``fedbench/reference/``, or one that lacks part
of the contract, is refused, and so is a cut that the program does not
take."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from fedbench import check, counts, harness, reference
from fedbench.tests import smallcell
from fedbench.tests.smallcell import ROOT

DENSE, DENSE_CONFIG = "stablelm-b8-stream", "stablelm-1.6b"
PROBE, PROBE_CONFIG = "probe-b8-stream", "probe-1.6b"
PROBE_REFERENCE = "fedbench/reference/probe.py"

#: a reference that runs the dense decoder's functions and records each
#: call with the module that made it
PROBE_SOURCE = '''
import sys

from fedbench.reference import decoder

CALLS = []


def _recorded(name):
    run = getattr(decoder, name)

    def call(*args, **kwargs):
        CALLS.append((name, sys._getframe(1).f_globals["__name__"]))
        return run(*args, **kwargs)
    return call


param_specs = _recorded("param_specs")
param_count = _recorded("param_count")
make_weights = _recorded("make_weights")
loss = _recorded("loss")
train_flops_per_step = _recorded("train_flops_per_step")
'''


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write(path: Path, obj: dict) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


def _config(root: Path, name: str) -> dict:
    return json.loads((root / "fedbench" / "configs" / f"{name}.json").read_text())


@pytest.fixture
def root(tmp_path: Path) -> Path:
    """The benchmark's files, with a third cell added by new files and
    appended entries alone: the dense cell's configuration under its own
    name and reference, its traffic, limits and CPU sizes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for part in ("configs", "traffic", "limits", "smoke", "metrics", "reference"):
        shutil.copytree(ROOT / "fedbench" / part, tmp_path / "fedbench" / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    files = tmp_path / "fedbench"
    (files / "reference" / "probe.py").write_text(PROBE_SOURCE)
    _write(files / "configs" / f"{PROBE_CONFIG}.json",
           {**_config(tmp_path, DENSE_CONFIG), "name": PROBE_CONFIG, "reference": PROBE_REFERENCE})
    shutil.copy(files / "smoke" / f"{DENSE_CONFIG}.json", files / "smoke" / f"{PROBE_CONFIG}.json")
    shutil.copy(files / "limits" / f"{DENSE}.json", files / "limits" / f"{PROBE}.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    dense = {c["name"]: c for c in bench["configs"]}[DENSE_CONFIG]
    bench["configs"].append({**dense, "name": PROBE_CONFIG,
                             "file": f"fedbench/configs/{PROBE_CONFIG}.json"})
    bench["workloads"].append({"name": PROBE, "config": PROBE_CONFIG, "traffic": "b8-stream",
                               "chips": 1, "why": "the dense cell through a reference of its own"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(PROBE)
    _write(tmp_path / "BENCHMARK.json", bench)
    return tmp_path


def test_third_cell_is_judged_by_its_own_reference(root):
    probe = harness.Cell(root, PROBE).reference
    assert probe.__file__ == str(root / PROBE_REFERENCE)
    probe.CALLS.clear()
    seed = 3_000_000_019
    result = smallcell.run(PROBE, seed=seed, root=root)
    assert result["correct"], result["checks"]
    assert {("make_weights", "fedbench.harness"),      # the program's round-0 weights
            ("make_weights", "fedbench.check"),        # the reference's own
            ("param_specs", "fedbench.check"),         # the sampled segments
            ("loss", "fedbench.reference.local")} <= set(probe.CALLS), probe.CALLS
    assert not {c for c in probe.CALLS if c[1] == "fedbench.counts"}

    probe.CALLS.clear()
    traced = smallcell.run(PROBE, seed=77, trace=True, root=root)
    assert traced["correct"], traced["checks"]
    assert {("train_flops_per_step", "fedbench.counts"),
            ("param_specs", "fedbench.counts")} <= set(probe.CALLS), probe.CALLS

    dense = smallcell.run(DENSE, seed=seed, root=root)
    assert {n: c["value"] for n, c in result["checks"].items()} == \
        {n: c["value"] for n, c in dense["checks"].items()}
    assert result["attempted"] == dense["attempted"]


def test_third_cell_counts_as_the_dense_one(root):
    mine, dense = harness.Cell(root, PROBE), harness.Cell(root, DENSE)
    mine.reference.CALLS.clear()
    fmts = check.wire_formats(mine.traffic)
    assert counts.flops_per_round(mine.config, mine.traffic) == \
        counts.flops_per_round(dense.config, dense.traffic)
    assert counts.codec_bytes_per_round(mine.config, mine.traffic, *fmts) == \
        counts.codec_bytes_per_round(dense.config, dense.traffic, *fmts)
    assert check.segments(mine.config, 5) == check.segments(dense.config, 5)
    assert {name for name, _ in mine.reference.CALLS} == {"train_flops_per_step", "param_specs"}


@pytest.mark.parametrize("path, says", [
    ("fedbench/metrics/round_mfu.py", "not a .py file under"),
    ("fedbench/reference/../metrics/round_mfu.py", "not a .py file under"),
    ("ABSOLUTE", "not a .py file under"),
    ("fedbench/reference/probe.json", "not a .py file under"),
    ("fedbench/reference/absent.py", "no such file"),
    ("fedbench/reference/partial.py", "does not export"),
], ids=["elsewhere", "dotdot", "absolute", "not-python", "missing", "partial"])
def test_reference_outside_its_directory_is_refused(root, path, says):
    (root / "fedbench" / "reference" / "partial.py").write_text(
        "from fedbench.reference.decoder import param_specs, make_weights, loss\n")
    if path == "ABSOLUTE":
        path = str(root / PROBE_REFERENCE)
    _write(root / "fedbench" / "configs" / f"{PROBE_CONFIG}.json",
           {**_config(root, PROBE_CONFIG), "reference": path})
    with pytest.raises(ValueError, match=says):
        harness.Cell(root, PROBE)
    with pytest.raises(ValueError, match=says):
        reference.load({"root": str(root), "reference": path})


@pytest.mark.parametrize("key, value", [("num_hidden_layers", 2), ("vocab_size", 256)],
                         ids=["key-unknown", "key-not-taken"])
def test_cut_the_program_has_no_key_for_is_refused(root, key, value):
    """A cut by a key the program's model configuration lacks, or one it
    has but does not take from the spec (all but ``num_layers``), is
    refused before anything is built: it would run uncut."""
    cfg = {**_config(root, PROBE_CONFIG), key: value, "reduced": [key]}
    _write(root / "fedbench" / "configs" / f"{PROBE_CONFIG}.json", cfg)
    small, traffic = smallcell.small(PROBE, root=root)
    cell = harness.Cell(root, PROBE)
    cell.traffic = traffic
    with pytest.raises(ValueError, match=key):
        harness.setup_round(cell, small, 1, "cpu", True)


def test_accepted_cells_hand_their_cut_to_the_program():
    for workload in smallcell.CELLS:
        cell = harness.Cell(ROOT, workload)
        spec = harness.job_spec(cell, cell.config, 1, False)
        assert spec["model_overrides"] == {k: cell.config[k] for k in cell.config["reduced"]}
        assert spec["num_layers"] == cell.config["num_layers"]
