"""The reader of the receiver's ``pinned`` arg on ``wire.reassemble``
spans: on made-up spans, on those of a program without the arg, and in a
small traced run of a cell on the CPU, whose decoder pins nothing."""
from __future__ import annotations

import pytest

from fedbench import harness
from fedbench.tests import smallcell
from fedbench.tests.smallcell import CELLS, ROOT
from fedbench.tests.test_fedbench_spans import _reading


def _reassemble(ts, nbytes, **pinned):
    return ["wire.reassemble", ts, 1.0, {"bytes": nbytes, "chunks": 2, "alloc_s": 1e-6,
                                         **pinned}]


_TRANSMIT = ["wire.transmit", 0.0, 9.0, {"kind": "task_data", "copied_bytes": 9}]


@pytest.mark.parametrize("spans, expect", [
    ([_TRANSMIT, _reassemble(1.0, 3, pinned=True), _reassemble(3.0, 1, pinned=True)], 100.0),
    ([_TRANSMIT, _reassemble(1.0, 3, pinned=True), _reassemble(3.0, 1, pinned=False)], 75.0),
    ([_TRANSMIT, _reassemble(1.0, 3, pinned=False)], 0.0),
    ([_TRANSMIT, _reassemble(1.0, 3), _reassemble(3.0, 1)], None),   # the parent's spans
    ([_TRANSMIT], None),                                              # no multi-chunk item
], ids=["all", "three-quarters", "none", "no-arg", "no-span"])
def test_pinned_share_on_made_up_spans(spans, expect):
    value = harness.Cell(ROOT, CELLS[0]).reader("reassembly_pinned_share")(_reading(spans))
    assert value == (None if expect is None else pytest.approx(expect))


@pytest.mark.parametrize("metric", ["reassembly_s", "reassembly_alloc_s"])
def test_accepted_readers_read_the_same_beside_the_pinned_arg(metric):
    read = harness.Cell(ROOT, CELLS[0]).reader(metric)
    bare = [_TRANSMIT, _reassemble(1.0, 3), _reassemble(3.0, 1)]
    pinned = [_TRANSMIT, _reassemble(1.0, 3, pinned=True), _reassemble(3.0, 1, pinned=False)]
    assert read(_reading(bare)) == read(_reading(pinned)) > 0


def test_cpu_run_reads_no_pinned_bytes():
    """The CPU decoder lands its tensors on the CPU: every multi-chunk
    item is assembled in ordinary host memory, and the share reads 0."""
    workload = "granite6-nf4-train"
    cfg, traffic = smallcell.small(workload)
    traffic["spec"]["chunk_mb"] = 1 / 64
    result = harness.run_cell(ROOT, workload, 3_000_000_113, 0.0, True, device="cpu",
                              config=cfg, traffic=traffic, smoke=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["reassembly_s"]["value"] > 0
    assert result["metrics"]["reassembly_pinned_share"]["value"] == 0.0
