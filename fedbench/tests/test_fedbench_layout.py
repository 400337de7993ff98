"""The harness finds every configuration with its reference, traffic
mix, limit file, CPU test sizes and metric reader by name; the
yardstick's counts against hand-worked values; the trace reader and the
host sampler on made-up inputs."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest

from fedbench import check, counts, devtrace, harness, hostmem
from fedbench.tests.smallcell import ROOT


def test_benchmark_cells_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    confs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == confs[w["config"]]["reduced"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == set(check.NAMES)
        assert cell.smoke and set(cell.smoke) <= set(cell.config)
        assert cell.reference.__file__ == str(ROOT / cell.config["reference"])
        assert cell.reference.param_count(cell.config) == cell.config["params"]
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} == {
            "round_s", "peak_device_gb", "peak_host_rss_gb", "setup_s"}


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.Cell(ROOT, "no-such-cell")


def test_train_flops_hand_worked():
    stablelm = harness.Cell(ROOT, "stablelm-b8-stream")
    granite = harness.Cell(ROOT, "granite6-nf4-train")
    # per token and layer: 2 (4 d^2 + 3 d f) + 4 s d; the head 2 d v; x 768 tokens x 3
    assert counts.train_flops_per_step(stablelm.config, 4, 192) == 6_716_255_109_120
    assert counts.flops_per_round(stablelm.config, stablelm.traffic) == 107_460_081_745_920
    # GQA: q and o 4096 x 4096, k and v 4096 x 1024; 6 layers; 2 clients x 12 steps
    assert counts.train_flops_per_step(granite.config, 4, 192) == 7_001_333_563_392
    assert counts.flops_per_round(granite.config, granite.traffic) == 168_032_005_521_408


def test_codec_bytes_hand_worked():
    stablelm = harness.Cell(ROOT, "stablelm-b8-stream")
    granite = harness.Cell(ROOT, "granite6-nf4-train")
    # blockwise8 a leaf: three times 5 n + 4 blocks (encode, decode, encode), the
    # int8 fold 9 n + 4 blocks: 24 n + 16 blocks; 401,433 blocks of 4096; 2 clients
    assert counts.codec_bytes_per_round(stablelm.config, stablelm.traffic,
                                        "blockwise8", "blockwise8") == 78_937_686_816
    # nf4 a leaf: four times 4.5 n + 4 blocks (the server decodes): 18 n + 16
    # blocks; n / 64 blocks; 2 clients
    assert counts.codec_bytes_per_round(granite.config, granite.traffic,
                                        "nf4", "nf4") == 62_463_518_720


def test_wire_formats_from_traffic():
    assert check.wire_formats(harness.Cell(ROOT, "stablelm-b8-stream").traffic) == \
        ("blockwise8", "blockwise8")
    assert check.wire_formats(harness.Cell(ROOT, "granite6-nf4-train").traffic) == ("nf4", "nf4")


class _Event:
    def __init__(self, name, dev, start, dur, corr):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_reading_on_made_up_events():
    mark = 1_000_000
    events = [
        _Event(devtrace.MARK, "DeviceType.CPU", mark, 10, 0),
        _Event("cudaLaunchKernel", "DeviceType.CPU", mark + 100, 5, 7),
        _Event("cudaLaunchKernel", "DeviceType.CPU", mark + 5_000, 5, 8),
        _Event("quantize", "DeviceType.CUDA", mark + 200, 1_000, 7),
        _Event("gemm", "DeviceType.CUDA", mark + 5_100, 2_000, 8),
    ]
    spans = {"traceEvents": [
        {"ph": "i", "name": devtrace.MARK, "ts": 50.0},
        {"ph": "X", "name": "kernel.quantize_batch", "ts": 50.0, "dur": 2.0, "args": {}},
        {"ph": "X", "name": "client.train", "ts": 54.0, "dur": 5.0, "args": {}},
    ], "otherData": {"dropped_events": 0}}
    tracer = types.SimpleNamespace(chrome_trace=lambda: spans)
    r = devtrace.TraceReading(events, tracer, 50.0, 10e-6)
    assert r.busy_s() == pytest.approx(3_000e-9)
    assert r.device_ops()[0] == ["gemm", pytest.approx(2e-6)]
    assert r.device_s_launched_in(("kernel.quantize_batch",)) == pytest.approx(1e-6)
    assert r.span_seconds("client.train") == pytest.approx(5e-6)
    gaps = dict((k, v) for k, v in r.idle_gaps())
    # idle: [0, 200) in the quantize span, [1200, 2000) in it too,
    # [2000, 4000) in no span, [4000, 5100) and [7100, 9000) in training,
    # [9000, 10000) in no span
    assert gaps["kernel.quantize_batch"] == pytest.approx(1_000e-9)
    assert gaps["client.train"] == pytest.approx(3_000e-9)
    assert gaps["no span"] == pytest.approx(3_000e-9)


def test_host_sampler_sees_a_short_peak():
    sampler = hostmem.HostSampler()
    try:
        base = sampler.reset()
        block = np.ones(64 << 20, dtype=np.uint8)   # 64 MiB, touched
        del block
        import time
        time.sleep(0.05)
        peak = sampler.stop()
    finally:
        sampler.close()
    assert peak - base >= 48 << 20
    assert sampler.proc.poll() is not None
