"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have, planted in the port, and the
control (the reference in TF32 put in the program's place) fails the
cell's limits.

The faults: local steps that return the weights unchanged; half of
every batch left out of the loss; the second client's uplink left out
of the server's fold; a code altered where the encoder produces it.
"""
from __future__ import annotations

import pytest
import torch

from fedbench import check, harness, readings
from fedbench.tests import smallcell


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _failed(result, *names):
    assert not result["correct"]
    bad = {n for n, c in result["checks"].items() if not c["value"] <= c["limit"]}
    assert set(names) <= bad, result["checks"]


@pytest.mark.parametrize("workload", smallcell.CELLS)
def test_state_left_unchanged(workload, monkeypatch):
    import repro_torch.fl.job as job

    monkeypatch.setattr(job, "adamw_update", lambda p, g, opt, lr: (p, opt, {}))
    _failed(smallcell.run(workload, seed=5), "change_gap")


def test_half_batch_left_out(monkeypatch):
    from repro_torch.models.transformer import DecoderLM

    full = DecoderLM.loss

    def half(self, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return full(self, params, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(DecoderLM, "loss", half)
    _failed(smallcell.run("granite6-nf4-train", seed=6, local_steps=3), "change_gap")


@pytest.mark.parametrize("workload", smallcell.CELLS)
def test_client_left_out_of_the_fold(workload, monkeypatch):
    import repro_torch.fl.aggregator as agg

    _, traffic = smallcell.small(workload)
    seed = smallcell.distinct_clients_seed(traffic)
    for cls in (agg.QuantizedFedAvgAggregator, agg.FedAvgAggregator):
        accept = cls.accept_item

        def skip_second(self, name, value, weight, _accept=accept):
            if self.accepted < 2:          # the second client's begin counts 2
                _accept(self, name, value, weight)

        monkeypatch.setattr(cls, "accept_item", skip_second)
    _failed(smallcell.run(workload, seed=seed), "fold_gap")


@pytest.mark.parametrize("workload", smallcell.CELLS)
def test_code_altered_where_produced(workload, monkeypatch):
    from repro_torch.kernels import ops

    for name in ("quantize_blockwise8", "quantize_4bit"):
        encode = getattr(ops, name)

        def altered(*args, _encode=encode):
            codes, absmax = _encode(*args)
            codes = codes.clone()
            codes.view(-1)[1] ^= 1
            return codes, absmax

        monkeypatch.setattr(ops, name, altered)
    _failed(smallcell.run(workload, seed=7), "downlink_mismatch", "uplink_mismatch")


@pytest.mark.parametrize("workload", smallcell.CELLS)
def test_control_and_faults_fail_the_limits(workload):
    cfg, traffic = smallcell.small(workload, local_steps=4, seq=64)
    cell = harness.Cell(smallcell.ROOT, workload)
    cell.traffic = traffic
    seed = smallcell.distinct_clients_seed(traffic, start=11)
    row = readings.seed_row(cell, cfg, seed, True, device="cpu", smoke=True)
    assert check.judge(row["program"], cell.limits)[0], row["program"]
    assert check.judge(row["ref_as_program"], cell.limits)[0], row["ref_as_program"]
    for fault in ("control_tf32", "half_batch", "unchanged", "client_dropped", "code_altered"):
        assert not check.judge(row[fault], cell.limits)[0], (fault, row[fault])
