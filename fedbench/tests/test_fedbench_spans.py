"""The readers of the wire's and the client trainer's spans
(``wire.stream``, ``wire.reassemble``, the meter's counts on
``wire.transmit``, ``train.*``): on made-up spans, beside the accepted
readers, which read the same with them as without, and in a small traced
run of a cell on the CPU."""
from __future__ import annotations

import types

import pytest

from fedbench import devtrace, harness
from fedbench.tests import smallcell
from fedbench.tests.smallcell import CELLS, ROOT
from fedbench.tests.test_fedbench_layout import _Event


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reading(spans, device=(), **more):
    """A traced reading of made-up spans (``[name, ts_us, dur_us, args]``)
    and device work (``[name, launch_us, start_us, dur_us]``), the window
    20 us long from the marker at span time 0."""
    mark = 1_000_000
    events = [_Event(devtrace.MARK, "DeviceType.CPU", mark, 10, 0)]
    for corr, (name, launch, start, dur) in enumerate(device, 1):
        events.append(_Event("cudaLaunchKernel", "DeviceType.CPU", mark + launch * 1000, 5,
                             corr))
        events.append(_Event(name, "DeviceType.CUDA", mark + start * 1000, dur * 1000, corr))
    trace = {"traceEvents": [{"ph": "i", "name": devtrace.MARK, "ts": 0.0}] + [
        {"ph": "X", "name": n, "ts": ts, "dur": dur, "args": args}
        for n, ts, dur, args in spans], "otherData": {"dropped_events": 0}}
    tracer = types.SimpleNamespace(chrome_trace=lambda: trace)
    return types.SimpleNamespace(trace=devtrace.TraceReading(events, tracer, 0.0, 20e-6),
                                 rounds=2, **more)


_WIRE = [
    ["wire.transmit", 0.0, 8.0, {"kind": "task_data", "copied_bytes": 3e9}],
    ["wire.stream", 1.0, 6.0, {"kind": "task_data", "chunks": 9, "bytes": 8}],
    ["wire.reassemble", 2.0, 2.0, {"bytes": 4, "chunks": 4, "alloc_s": 0.5e-6}],
    ["wire.reassemble", 5.0, 1.0, {"bytes": 2, "chunks": 2, "alloc_s": 0.25e-6}],
    ["wire.transmit", 10.0, 4.0, {"kind": "task_result", "copied_bytes": 1e9}],
]
# a program without these spans: no reassembly, transmits without the meter's counts
_BARE = [["wire.transmit", 0.0, 8.0, {"kind": "task_data"}],
         ["client.train", 10.0, 6.0, {"client": "site-0", "round": 0}]]
_TRAIN = [["client.train", 10.0, 8.0, {"client": "site-0", "round": 0}],
          ["train.forward", 10.5, 1.0, {"step": 0}],
          ["train.optimizer", 12.0, 1.0, {"step": 0}]]
_KERNELS = [["gemm", 11, 13, 3], ["adamw", 12.5, 16, 1]]


@pytest.mark.parametrize("metric, spans, device, expect", [
    ("reassembly_s", _WIRE, (), 1.5e-6),
    ("reassembly_s", _BARE, (), None),
    ("reassembly_alloc_s", _WIRE, (), 0.375e-6),
    ("reassembly_alloc_s", _BARE, (), None),
    ("wire_copy_gb", _WIRE, (), 2.0),
    ("wire_copy_gb", _BARE, (), None),
    ("adamw_device_share", _TRAIN, _KERNELS, 25.0),
    ("adamw_device_share", _TRAIN, (), None),           # no device work (the CPU)
    ("adamw_device_share", _BARE, _KERNELS, None),       # no optimizer span
    ("adamw_device_share", _TRAIN[:2], _KERNELS, None),
], ids=lambda v: v if isinstance(v, str) else None)
def test_new_span_readers_on_made_up_spans(metric, spans, device, expect):
    value = harness.Cell(ROOT, CELLS[0]).reader(metric)(_reading(spans, device))
    assert value == (None if expect is None else pytest.approx(expect))


# spans of a program without the wire and trainer spans, then the same with them
_BEFORE = [["wire.transmit", 0.0, 8.0, {"kind": "task_data"}],
           ["kernel.quantize_batch", 0.5, 1.0, {}],
           ["client.train", 9.0, 6.0, {"client": "site-0", "round": 0}],
           ["wire.transmit", 16.0, 3.0, {"kind": "task_result"}],
           ["stage.decode.quantize", 17.0, 1.0, {}]]
_AFTER = [[n, ts, dur, {**args, "copied_bytes": 7, "allocated_bytes": 9}
           if n == "wire.transmit" else args] for n, ts, dur, args in _BEFORE] + [
    ["wire.stream", 1.6, 6.0, {"kind": "task_data", "chunks": 3, "bytes": 5}],
    ["wire.reassemble", 2.0, 3.0, {"bytes": 4, "chunks": 2, "alloc_s": 1e-6}],
    ["train.setup", 9.0, 1.0, {}], ["train.forward", 10.0, 1.0, {"step": 0}],
    ["train.optimizer", 12.0, 1.0, {"step": 0}], ["host.gc", 13.0, 0.5, {}],
    ["wire.stream", 16.2, 2.5, {"kind": "task_result", "chunks": 2, "bytes": 3}]]
_CODEC = [["quantize", 0.8, 1, 2], ["gemm", 10.5, 11, 3], ["adamw", 12.5, 14, 1],
          ["dequantize", 17.5, 18, 1]]


@pytest.mark.parametrize("metric", ["downlink_s", "uplink_s", "local_train_s",
                                    "codec_hbm_share"])
def test_accepted_readers_read_the_same_beside_the_new_spans(metric):
    read = harness.Cell(ROOT, CELLS[0]).reader(metric)
    more = dict(peaks={"hbm_bytes_per_s": 1e12}, codec_bytes_per_round=1e6)
    before = read(_reading(_BEFORE, _CODEC, **more))
    assert before is not None and before > 0
    assert read(_reading(_AFTER, _CODEC, **more)) == before


def test_traced_run_reads_the_wire_and_trainer_spans():
    """With chunks cut to 1/64 MiB the smoke model's larger items span
    several chunks: the reassembly and copy readings are there; AdamW's
    share of device time is left out on the CPU, which has none."""
    workload = "stablelm-b8-stream"
    cfg, traffic = smallcell.small(workload)
    traffic["spec"]["chunk_mb"] = 1 / 64
    result = harness.run_cell(ROOT, workload, 3_000_000_071, 0.0, True, device="cpu",
                              config=cfg, traffic=traffic, smoke=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("reassembly_s", "reassembly_alloc_s", "wire_copy_gb"):
        assert metrics[name]["value"] > 0, name
    assert metrics["reassembly_alloc_s"]["value"] <= metrics["reassembly_s"]["value"]
    assert "adamw_device_share" not in metrics
