"""The port's span tracer inside the wire's stream and the client's step.

A traced smoke federation with items cut into many chunks: one
``wire.stream`` a transfer (carrying the message kind), one
``wire.reassemble`` a multi-chunk item (its wire length, its chunks, an
allocation inside its time), every span nested in its ``wire.transmit``
on that thread, and the transmits' ``copied_bytes`` summing to the
``MemoryMeter``'s count. The ``train.*`` spans in order inside each
``client.train``. A full collection under an active tracer is one
``host.gc`` span, and the collector's callback goes with the tracer.
``otherData["clock"]`` lays a span beside ``torch.profiler``'s events.
Imports torch and the port only.
"""
from __future__ import annotations

import gc
import json
import math
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from repro_torch.fl.job import build_job
from repro_torch.obs import Tracer, activate, validate_chrome_trace
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 1 << 14          # 1/64 MiB: the smoke model's larger items span many chunks
LOCAL_STEPS = 2
TRAIN_SPANS = ("train.batch", "train.forward", "train.backward", "train.optimizer")


def _traced_round(**overrides):
    """One traced round of the stablelm cell's traffic at smoke width: the
    job, its exported trace and its ``X`` events."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spec = json.loads((ROOT / "fedbench/traffic/b8-stream.json").read_text())["spec"]
        spec = {**spec, "arch": "stablelm-1.6b", "smoke": True, "rounds": 1, "seed": 5,
                "local_steps": LOCAL_STEPS, "seq": 32, "chunk_mb": CHUNK / (1 << 20),
                "trace": True, **overrides}
        job = build_job(spec, device="cpu")
        job.run()
    finally:
        torch.set_num_threads(threads)
    trace = job.sim.tracer.chrome_trace()
    assert trace["otherData"]["dropped_events"] == 0
    validate_chrome_trace(trace)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    return job, trace, spans


@pytest.fixture(scope="module")
def traced():
    return _traced_round()


def _named(spans, name):
    return [e for e in spans if e["name"] == name]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _within(spans, outer):
    return [e for e in spans if e is not outer and _inside(e, outer)]


def test_one_stream_span_a_transfer_with_its_kind(traced):
    _, _, spans = traced
    transmits = _named(spans, "wire.transmit")
    assert len(transmits) == 4           # 2 clients, both ways
    for tx in transmits:
        streams = [e for e in _within(spans, tx) if e["name"] == "wire.stream"]
        assert len(streams) == 1
        st = streams[0]["args"]
        assert st["kind"] == tx["args"]["kind"]
        # the stream carries the items' wire bytes; the transmit adds the
        # frame headers and the item count
        assert 0 < st["bytes"] < tx["args"]["wire_bytes"]
        assert st["chunks"] >= math.ceil(st["bytes"] / CHUNK)
    assert len(_named(spans, "wire.stream")) == len(transmits)


def test_regular_transmission_streams_one_blob_a_transfer():
    """The regular path: the whole message is one ``wire.stream`` blob,
    received whole, so no item is reassembled."""
    _, _, spans = _traced_round(transmission="regular")
    transmits = _named(spans, "wire.transmit")
    assert len(transmits) == 4
    for tx in transmits:
        streams = [e for e in _within(spans, tx) if e["name"] == "wire.stream"]
        assert len(streams) == 1
        st = streams[0]["args"]
        assert st["kind"] == tx["args"]["kind"]
        assert st["chunks"] == math.ceil(st["bytes"] / CHUNK)
        assert 0 < st["bytes"] < tx["args"]["wire_bytes"]
    assert not _named(spans, "wire.reassemble")


def test_one_reassemble_span_a_multi_chunk_item(traced):
    _, _, spans = traced
    for tx in _named(spans, "wire.transmit"):
        inner = _within(spans, tx)
        # each payload item's wire length, from its encode span
        lengths = [e["args"]["bytes_out"] for e in inner if e["name"] == "wire.encode_item"]
        multi = sorted(n for n in lengths if n > CHUNK)
        assert multi, "the cut chunk size leaves no item spanning several chunks"
        reassembled = [e for e in inner if e["name"] == "wire.reassemble"]
        assert sorted(e["args"]["bytes"] for e in reassembled) == multi
        for e in reassembled:
            assert e["args"]["chunks"] == math.ceil(e["args"]["bytes"] / CHUNK)
            assert 0 <= e["args"]["alloc_s"] <= e["dur"] / 1e6
    # the decode of an item starts after its reassembly ends
    decodes = _named(spans, "wire.decode_item")
    for e in _named(spans, "wire.reassemble"):
        end = e["ts"] + e["dur"]
        assert not any(d["ts"] < end < d["ts"] + d["dur"] for d in decodes)


def test_wire_spans_nest_in_their_transmit(traced):
    _, _, spans = traced
    transmits = _named(spans, "wire.transmit")
    for e in _named(spans, "wire.stream") + _named(spans, "wire.reassemble"):
        assert sum(_inside(e, tx) for tx in transmits) == 1, e
    for tx in transmits:
        inner = _within(spans, tx)
        stream = next(e for e in inner if e["name"] == "wire.stream")
        # loopback hands each chunk to the receiver from the sender's loop,
        # so an item's reassembly runs inside its transfer's stream
        assert all(_inside(e, stream) for e in inner if e["name"] == "wire.reassemble")


def test_copied_bytes_sum_to_the_meter(traced):
    job, _, spans = traced
    meter = job.sim.meter.as_dict()
    transmits = _named(spans, "wire.transmit")
    assert sum(e["args"]["copied_bytes"] for e in transmits) == meter["copied"]
    assert sum(e["args"]["allocated_bytes"] for e in transmits) == meter["total_allocated"]
    assert all(e["args"]["copied_bytes"] > 0 for e in transmits)


def test_train_spans_in_order_inside_client_train(traced):
    _, _, spans = traced
    trains = _named(spans, "client.train")
    assert len(trains) == 2
    names = {"train.setup", "train.readback", *TRAIN_SPANS}
    for ct in trains:
        inner = sorted((e for e in _within(spans, ct) if e["name"] in names),
                       key=lambda e: e["ts"])
        expect = ["train.setup"] + list(TRAIN_SPANS) * LOCAL_STEPS + ["train.readback"]
        assert [e["name"] for e in inner] == expect
        steps = [e["args"]["step"] for e in inner if e["name"] in TRAIN_SPANS]
        assert steps == [s for s in range(LOCAL_STEPS) for _ in TRAIN_SPANS]
        for a, b in zip(inner, inner[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
    # client.train keeps its name and args
    assert {tuple(sorted(e["args"])) for e in trains} == {("client", "round")}


def test_new_spans_come_once_a_transfer_item_step_or_collection(traced):
    """No span a chunk: the new names are bounded by transfers, multi-chunk
    items, local steps and full collections."""
    _, trace, spans = traced
    count = defaultdict(int)
    for e in spans:
        count[e["name"]] += 1
    chunks = sum(e["args"]["chunks"] for e in _named(spans, "wire.stream"))
    items = len(_named(spans, "wire.encode_item"))
    assert count["wire.stream"] == count["wire.transmit"]
    assert count["wire.reassemble"] <= items < chunks
    for name in TRAIN_SPANS:
        assert count[name] == 2 * LOCAL_STEPS
    assert len(spans) < chunks


def test_a_full_collection_is_one_gc_span_and_the_callback_goes_with_the_tracer():
    before = list(gc.callbacks)
    tracer = Tracer()
    with activate(tracer):
        assert gc.callbacks.count(obs_trace._gc_span) == 1
        with activate(Tracer()):        # a nested activation leaves one callback
            assert gc.callbacks.count(obs_trace._gc_span) == 1
        assert gc.callbacks.count(obs_trace._gc_span) == 1
        gc.collect(0)                   # a young generation: no span
        gc.collect()
    assert gc.callbacks == before
    gcs = [e for e in tracer.chrome_trace()["traceEvents"] if e.get("name") == "host.gc"]
    assert len(gcs) == 1
    assert set(gcs[0]["args"]) == {"collected", "uncollectable"}
    assert gcs[0]["dur"] >= 0
    gc.collect()                        # no tracer: nothing recorded
    assert tracer.total_events == 1


def test_the_clock_pairs_lay_a_span_beside_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the first range pays the profiler's set-up (about 1 ms here)
        # between its timestamp and the code inside it
        with torch.profiler.record_function("trace.warm"):
            torch.ones(4).sum()
        with torch.profiler.record_function("trace.align"):
            tracer.instant("trace.align")
    trace = tracer.chrome_trace()
    clock = trace["otherData"]["clock"]
    assert clock["export"]["perf_ns"] >= clock["epoch"]["perf_ns"]
    ts = next(e["ts"] for e in trace["traceEvents"] if e.get("name") == "trace.align")
    start = next(ev.start_ns() for ev in prof.profiler.kineto_results.events()
                 if ev.name() == "trace.align")
    assert abs(obs_trace.profiler_ns(trace, ts) - start) < 1_000_000


def test_profiler_ns_interpolates_between_the_pairs():
    trace = {"otherData": {"clock": {"epoch": {"perf_ns": 1_000, "unix_ns": 5_000_000},
                                     "export": {"perf_ns": 1_001_000, "unix_ns": 6_000_100}}}}
    assert obs_trace.profiler_ns(trace, 0.0) == 5_000_000
    assert obs_trace.profiler_ns(trace, 1_000.0) == 6_000_100     # the export pair
    assert obs_trace.profiler_ns(trace, 500.0) == 5_500_050       # drift shared out
