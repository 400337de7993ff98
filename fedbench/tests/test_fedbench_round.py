"""A whole run of each cell on the CPU at small sizes: the port's round
through the harness, judged against the plain reference, comes out
correct, with every metric the contract asks for."""
from __future__ import annotations

import pytest

from fedbench import check
from fedbench.tests import smallcell


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("workload", smallcell.CELLS)
def test_port_round_matches_reference(workload):
    result = smallcell.run(workload, seed=3_000_000_019)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(check.NAMES)
    assert set(result["metrics"]) == {"round_s", "peak_device_gb", "peak_host_rss_gb",
                                      "setup_s"}
    assert result["attempted"] == 2 and result["failed"] == 0
    assert result["checks"]["downlink_mismatch"]["value"] == 0
    assert result["checks"]["uplink_mismatch"]["value"] == 0


def test_traced_run_reports_the_layers():
    result = smallcell.run("granite6-nf4-train", seed=77, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("downlink_s", "uplink_s", "local_train_s", "device_idle_pct",
                 "wire_buffer_peak_mb"):
        assert metrics[name]["value"] > 0, name
    # no device peaks on the CPU: the shares of a peak are left out, never 0
    assert "round_mfu" not in metrics and "codec_hbm_share" not in metrics
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
def test_small_round_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedbench import harness

    cfg, traffic = smallcell.small("stablelm-b8-stream")
    result = harness.run_cell(smallcell.ROOT, "stablelm-b8-stream", 4_000_000_033, 1.0, True,
                              device="cuda", config=cfg, traffic=traffic, smoke=True)
    assert result["correct"], result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]
