"""Port parity: the legacy filters (``core/filters.py``), their stage twins
(``ef-quantize``, ``dp-noise``, ``adaptive``) and the legacy adapters of
``core/pipeline.py``, against the reference on the same seeded numpy
inputs, on the CPU.

Tolerance: none. Everything that crosses the wire is compared bitwise —
int8 codes, packed nibbles, absmax, headers (``quantized_fmt``,
``mixed:...``, ``error_feedback``), each item's serialized bytes — and so
are the values a filter hands on (dequantized tensors, DP-noised tensors,
error-feedback residuals).

Subnormals: the reference's kernels flush float32 subnormals (XLA on
the CPU runs with FTZ/DAZ) while its numpy-side arithmetic keeps them:
the DP noise sum and the error-feedback residual ``corrected - deq``.
The port flushes in its kernels' plain versions and keeps subnormals in
torch arithmetic, so the cases with subnormal inputs below must agree
bitwise on both sides of that line.

Shared instances: the reference's job builds one filter per point for
all clients, so one DP generator is drawn in client order and one
error-feedback residual is kept per tensor name across clients. The
cases with two clients hold the port to that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import filters as RF  # noqa: E402
from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import serialization as ref_ser  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.core.quantization import QuantizedTensor as RefQT  # noqa: E402
from repro.fl.aggregator import FedAvgAggregator as RefFedAvg  # noqa: E402
from repro.fl.executor import TrainExecutor as RefExecutor  # noqa: E402
from repro.fl.simulator import FLSimulator as RefSimulator  # noqa: E402
from repro.fl.simulator import SimulationConfig as RefConfig  # noqa: E402
from repro_torch.core import filters as F  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.core.quantization import QuantizedTensor  # noqa: E402
from repro_torch.fl.aggregator import FedAvgAggregator  # noqa: E402
from repro_torch.fl.executor import TrainExecutor  # noqa: E402
from repro_torch.fl.simulator import FLSimulator, SimulationConfig  # noqa: E402
from repro_torch.kernels.ref import FLT_MIN  # noqa: E402

CPU = "cpu"
FORMATS = ("fp32", "fp16", "blockwise8", "nf4", "fp4")


def _payload(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    """Items of several sizes (one ragged past a 4096-block, one under a
    64-block), an integer item and a 0-d scalar."""
    rng = np.random.default_rng(seed)
    return {
        "embed.w": (rng.standard_normal((96, 64)) * scale).astype(np.float32),
        "layers.0.mlp": (rng.standard_normal(4096 + 70) * scale).astype(np.float32),
        "layers.0.norm": (1.0 + 0.1 * rng.standard_normal(40) * scale).astype(np.float32),
        "step": np.arange(6, dtype=np.int32),
        "scale": np.float32(0.5 * scale),
    }


def _subnormal_payload(seed: int) -> dict[str, np.ndarray]:
    """Subnormal elements, small normal ones whose sums and residuals go
    subnormal, and ordinary ones, in the same tensors."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 80)).astype(np.float32)
    w[::3] *= np.float32(1e-39)
    w[1::3] *= np.float32(3e-38)
    b = (rng.standard_normal(130) * 1e-40).astype(np.float32)
    return {"layer.w": w, "layer.b": b}


def _msgs(payload, headers=None, kind="task_result"):
    headers = dict(headers or {})
    return (Message(MessageKind(kind), dict(payload), dict(headers)),
            RefMessage(RefKind(kind), dict(payload), dict(headers)))


def _wire(name, value, serializer):
    return serializer.serialize_item(name, value)


def _same_wire(port_msg, ref_msg):
    """Every item serialized by each package's codec, bitwise; headers equal."""
    assert list(port_msg.payload) == list(ref_msg.payload)
    for name, value in ref_msg.payload.items():
        got = port_msg.payload[name]
        assert isinstance(got, QuantizedTensor) == isinstance(value, RefQT), name
        assert _wire(name, got, ser) == _wire(name, value, ref_ser), name
    assert port_msg.headers == ref_msg.headers


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _bitwise(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the filters against their reference twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("min_params", [0, 100])
def test_quantize_filter_wire_form_equals_reference(fmt, min_params):
    port, ref = _msgs(_payload(1), {"client": "site-0", "round": 0})
    got = F.QuantizeFilter(fmt, min_params, device=CPU).process(port)
    want = RF.QuantizeFilter(fmt, min_params).process(ref)
    _same_wire(got, want)
    assert got.headers["quantized_fmt"] == fmt
    quantized = {n for n, v in got.payload.items() if isinstance(v, QuantizedTensor)}
    assert quantized == ({"embed.w", "layers.0.mlp"} if min_params
                         else {"embed.w", "layers.0.mlp", "layers.0.norm", "scale"})
    # payloads stay on the filter's device as torch tensors until the wire
    assert isinstance(got.payload["embed.w"].payload, torch.Tensor)


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_filter_values_equal_reference(fmt):
    """Both decode the same wire bytes (the reference's quantized message,
    serialized and parsed back, as a receiver sees it)."""
    _, ref = _msgs(_payload(2))
    wire = ref_ser.serialize_container(RF.QuantizeFilter(fmt).process(ref).payload)
    headers = {"quantized_fmt": fmt, "round": 3}
    port_in = Message(MessageKind.TASK_DATA, ser.deserialize_container(wire), dict(headers))
    ref_in = RefMessage(RefKind.TASK_DATA, ref_ser.deserialize_container(wire), dict(headers))
    got = F.DequantizeFilter(CPU).process(port_in)
    want = RF.DequantizeFilter().process(ref_in)
    assert list(got.payload) == list(want.payload) == list(_payload(2))
    assert got.headers == want.headers == {"round": 3}
    for name, value in want.payload.items():
        _bitwise(got.payload[name], value)


def test_selective_quantize_filter_equals_reference():
    rules = [("norm", "fp16"), ("embed", None), ("mlp", "fp4")]
    port, ref = _msgs(_payload(3))
    got = F.SelectiveQuantizeFilter(rules, default_fmt="blockwise8", device=CPU).process(port)
    want = RF.SelectiveQuantizeFilter(rules, default_fmt="blockwise8").process(ref)
    _same_wire(got, want)
    assert got.headers["quantized_fmt"] == "mixed:blockwise8,fp16,fp4"
    assert not isinstance(got.payload["embed.w"], QuantizedTensor)


@pytest.mark.parametrize("subnormal", [False, True], ids=["normal", "subnormal"])
def test_dp_noise_filter_shared_by_two_clients_equals_reference(subnormal):
    """One generator, drawn in client order, over two rounds; numpy and
    torch inputs give the same bits. With subnormal inputs and a sigma
    whose noise is subnormal too, the sums keep their subnormals (numpy
    in the reference)."""
    sigma = 1e-39 if subnormal else 0.05
    port_f, ref_f = F.DPGaussianNoiseFilter(sigma, seed=7), RF.DPGaussianNoiseFilter(sigma, seed=7)
    kept = 0
    for rnd in range(2):
        for client in range(2):
            payload = _subnormal_payload(10 * rnd + client) if subnormal \
                else _payload(10 * rnd + client)
            as_torch = {k: torch.from_numpy(np.array(v)) for k, v in payload.items()}
            port, _ = _msgs(as_torch if client else payload, {"client": f"site-{client}"})
            _, ref = _msgs(payload, {"client": f"site-{client}"})
            got, want = port_f.process(port), ref_f.process(ref)
            assert list(got.payload) == list(want.payload)
            for name, value in want.payload.items():
                _bitwise(got.payload[name], value)
            if subnormal:
                w = np.abs(np.asarray(want.payload["layer.w"]))
                kept += int(((w > 0) & (w < FLT_MIN)).sum())
    if subnormal:
        assert kept > 0, "no subnormal reached the noised tensors"


@pytest.mark.parametrize("fmt", ["blockwise8", "nf4", "fp16"])
@pytest.mark.parametrize("subnormal", [False, True], ids=["normal", "subnormal"])
def test_error_feedback_filter_three_rounds_two_clients_equals_reference(fmt, subnormal):
    """One filter shared by two clients keeps one residual per tensor
    name across them (the reference's keying); over three rounds the
    wire and the residuals stay bitwise equal. With subnormal inputs the
    quantize flushes (kernel) while the residual keeps them (plain
    arithmetic), on both sides."""
    port_f = F.ErrorFeedbackQuantizeFilter(fmt, device=CPU)
    ref_f = RF.ErrorFeedbackQuantizeFilter(fmt)
    for rnd in range(3):
        for client in range(2):
            payload = _subnormal_payload(10 * rnd + client) if subnormal \
                else _payload(10 * rnd + client)
            port, ref = _msgs(payload, {"client": f"site-{client}"})
            got, want = port_f.process(port), ref_f.process(ref)
            _same_wire(got, want)
            assert got.headers["error_feedback"] is True
            assert set(port_f._residual) == set(ref_f._residual)
            for name, res in ref_f._residual.items():
                _bitwise(port_f._residual[name], res)
    if subnormal and fmt != "fp16":
        r = np.abs(np.asarray(ref_f._residual["layer.w"]))
        assert ((r > 0) & (r < FLT_MIN)).any(), "no subnormal residual"


class _Links:
    """A link()-shaped network: per-client bandwidth in Mbit/s."""

    def __init__(self, mbps):
        self.mbps = mbps

    def link(self, client):
        return type("Link", (), {"bandwidth_mbps": self.mbps[client]})()


def _ladder_bandwidths(n_params: int) -> list[float]:
    """Bits/s on both sides of every rung's budget of 1 s, plus one so slow
    that even the last rung (nf4) misses it."""
    out = []
    for bits in (32, 16, 8 + 32 / 4096, 4 + 32 / 64):
        need = n_params * bits
        out += [need * 1.01, need * 0.99]
    return out + [10.0]


def test_adaptive_filter_picks_the_reference_format_on_every_rung():
    payload = _payload(4)
    n = sum(int(np.prod(np.shape(v))) for v in payload.values()
            if np.issubdtype(np.asarray(v).dtype, np.floating))
    picked = []
    for bw in _ladder_bandwidths(n):
        port, ref = _msgs(payload, {"client": "site-0"})
        got = F.AdaptiveQuantizeFilter(bandwidth_bps=bw, device=CPU).process(port)
        ref_filter = RF.AdaptiveQuantizeFilter(bandwidth_bps=bw)
        want = ref_filter.process(ref)
        _same_wire(got, want)
        picked.append(ref_filter.last_fmt)
    assert picked == ["fp32", "fp16", "fp16", "blockwise8", "blockwise8", "nf4",
                      "nf4", "nf4", "nf4"]


def test_adaptive_filter_per_client_links_and_missing_client_equal_reference():
    links = _Links({"site-0": 1e-3, "site-1": 1e4})
    port_f = F.AdaptiveQuantizeFilter.from_network(links, device=CPU)
    ref_f = RF.AdaptiveQuantizeFilter.from_network(links)
    for client in ("site-0", "site-1"):
        port, ref = _msgs(_payload(5), {"client": client})
        _same_wire(port_f.process(port), ref_f.process(ref))
    assert port_f.last_fmt_by_client == ref_f.last_fmt_by_client == \
        {"site-0": "nf4", "site-1": "fp32"}
    port, ref = _msgs(_payload(5))
    with pytest.raises(ValueError, match="no 'client' header"):
        ref_f.process(ref)
    with pytest.raises(ValueError, match="no 'client' header"):
        port_f.process(port)
    bound = F.AdaptiveQuantizeFilter(bandwidth_bps=1.0, device=CPU)
    bound.bind_network(links)
    assert bound.fmt_for(_msgs(_payload(5), {"client": "site-1"})[0]) == "fp32"
    assert bound.fmt_for(_msgs(_payload(5))[0]) == "nf4"   # fleet-wide fallback
    with pytest.raises(ValueError, match="need bandwidth_bps"):
        F.AdaptiveQuantizeFilter()


def test_two_way_quantization_and_no_filters_have_the_reference_layout():
    port, ref = F.two_way_quantization("nf4", device=CPU), RF.two_way_quantization("nf4")
    assert [p.value for p in port] == [p.value for p in ref]
    for point in RF.FilterPoint:
        got = [type(f).__name__ for f in port[F.FilterPoint(point.value)].filters]
        assert got == [type(f).__name__ for f in ref[point].filters]
    assert all(not c.filters for c in F.no_filters().values())


def test_filters_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    for make in (lambda: F.QuantizeFilter("blockwise8"), lambda: F.DequantizeFilter(),
                 lambda: F.ErrorFeedbackQuantizeFilter("nf4"),
                 lambda: F.SelectiveQuantizeFilter([], "nf4"),
                 lambda: F.two_way_quantization("blockwise8")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    adaptive = F.AdaptiveQuantizeFilter(bandwidth_bps=10.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        adaptive.process(_msgs(_payload(6))[0])


# ---------------------------------------------------------------------------
# the stage twins against the reference's stages, and against the filters
# ---------------------------------------------------------------------------

def _encode(pipeline, message):
    msg, ctx = pipeline.begin_encode(message)
    return [ser.join_views(v) for _n, v in pipeline.iter_encode_views(msg, ctx)]


def _ref_encode(pipeline, message):
    msg, ctx = pipeline.begin_encode(message)
    return [ref_ser.join_views(v) for _n, v in pipeline.iter_encode_views(msg, ctx)]


@pytest.mark.parametrize("stack", [
    ["ef-quantize:blockwise8", "crc32"],
    ["ef-quantize:nf4"],
    [{"stage": "dp-noise", "sigma": 0.05, "seed": 3}, "quantize:blockwise8"],
    [{"stage": "dp-noise", "sigma": 1e-39, "seed": 3}],
    [{"stage": "adaptive", "bandwidth_bps": 2.0e5}, "crc32"],
    ["adaptive:5e7"],
], ids=["ef8-crc", "ef-nf4", "dp-q8", "dp-subnormal", "adaptive-crc", "adaptive-fp32"])
def test_stage_twin_envelopes_equal_reference_three_rounds_two_clients(stack):
    """Stateful stages serve a whole hop: one instance, two clients, three
    rounds; every envelope bitwise, including subnormal inputs."""
    port, ref = pl.build_pipeline(stack, device=CPU), ref_pl.build_pipeline(stack)
    for rnd in range(3):
        for client in range(2):
            payload = (_subnormal_payload if "1e-39" in str(stack) else _payload)(
                10 * rnd + client)
            headers = {"client": f"site-{client}", "round": rnd, "num_samples": 5}
            pm, rm = _msgs(payload, headers)
            assert _encode(port, pm) == _ref_encode(ref, rm), (rnd, client)
    for stage in port.stages:
        if isinstance(stage, pl.ErrorFeedbackQuantizeStage):
            ref_stage = ref.stages[0]
            assert set(stage._residual) == set(ref_stage._residual)
            assert {c for c, _ in stage._residual} == {"site-0", "site-1"}
            for key, res in ref_stage._residual.items():
                _bitwise(stage._residual[key], res)
        if isinstance(stage, pl.AdaptiveQuantizeStage):
            assert stage.last_fmt_by_client == ref.stages[0].last_fmt_by_client


@pytest.mark.parametrize("stage", ["ef-quantize", "dp-noise", "adaptive"])
def test_ported_stage_twins_leave_the_not_ported_list(stage):
    assert stage in pl.registered_stages() and stage not in pl.NOT_PORTED_STAGES
    built = pl.build_pipeline([f"{stage}:blockwise8" if stage == "ef-quantize"
                               else {"stage": stage, "sigma": 0.1} if stage == "dp-noise"
                               else stage], device=CPU)
    assert built.stages[0].stateful == ref_pl._lookup(stage).stateful == (stage != "adaptive")


def _filter_then_serialize(filt, message):
    out = filt.process(message)
    return {n: ser.serialize_item(n, v) for n, v in out.payload.items()}, out.headers


def _stage_items(pipeline, message):
    """Each item as the value stages leave it, serialized by the inner codec."""
    msg, ctx = pipeline.begin_encode(message)
    out = {}
    for name, value in msg.payload.items():
        for s in pipeline.stages:
            value = s.encode_item(name, value, ctx)
        out[name] = ser.serialize_item(name, value)
    return out, ctx.headers


@pytest.mark.parametrize("twin", ["quantize", "selective", "ef", "dp", "adaptive"])
def test_filter_equals_its_stage_twin_bitwise(twin):
    """One client, three rounds: the filter and its per-item stage twin
    put the same bytes on the wire and the same headers on the message
    (for ``ef`` the stage's per-client key and the filter's per-name key
    coincide with one client)."""
    make = {
        "quantize": (lambda: F.QuantizeFilter("nf4", device=CPU), ["quantize:nf4"]),
        "selective": (lambda: F.SelectiveQuantizeFilter([("norm", "fp16")], "blockwise8",
                                                        device=CPU),
                      [{"stage": "quantize", "rules": [["norm", "fp16"]],
                        "fmt": "blockwise8"}]),
        "ef": (lambda: F.ErrorFeedbackQuantizeFilter("nf4", device=CPU), ["ef-quantize:nf4"]),
        "dp": (lambda: F.DPGaussianNoiseFilter(0.1, seed=5),
               [{"stage": "dp-noise", "sigma": 0.1, "seed": 5}]),
        "adaptive": (lambda: F.AdaptiveQuantizeFilter(bandwidth_bps=3e5, device=CPU),
                     [{"stage": "adaptive", "bandwidth_bps": 3e5}]),
    }[twin]
    filt, pipeline = make[0](), pl.build_pipeline(make[1], device=CPU)
    for rnd in range(3):
        headers = {"client": "site-0", "round": rnd}
        payload = _payload(20 + rnd)
        by_filter, fh = _filter_then_serialize(filt, _msgs(payload, headers)[0])
        by_stage, sh = _stage_items(pipeline, _msgs(payload, headers)[0])
        assert by_filter == by_stage, rnd
        assert fh == sh


# ---------------------------------------------------------------------------
# the legacy adapters
# ---------------------------------------------------------------------------

def test_filter_is_stateful_like_the_reference():
    class Custom(F.Filter):
        pass

    class Declared(F.Filter):
        stateful = False

    cases = [
        (F.QuantizeFilter("nf4", device=CPU), RF.QuantizeFilter("nf4")),
        (F.DequantizeFilter(CPU), RF.DequantizeFilter()),
        (F.SelectiveQuantizeFilter([], device=CPU), RF.SelectiveQuantizeFilter([])),
        (F.AdaptiveQuantizeFilter(1e6), RF.AdaptiveQuantizeFilter(1e6)),
        (F.ErrorFeedbackQuantizeFilter("nf4", device=CPU),
         RF.ErrorFeedbackQuantizeFilter("nf4")),
        (F.DPGaussianNoiseFilter(0.1), RF.DPGaussianNoiseFilter(0.1)),
        (Custom(), Custom()), (Declared(), Declared()),
    ]
    for port, ref in cases:
        assert pl._filter_is_stateful(port) == ref_pl._filter_is_stateful(ref), port
    stage = pl.FilterStage(F.DPGaussianNoiseFilter(0.1))
    assert stage.stateful and stage.name == "filter:DPGaussianNoiseFilter"


def test_legacy_pipelines_frame_like_the_reference_and_charge_held_bytes():
    """The two-way scheme's hops: the egress filter replaces the payload
    in ``begin_encode`` (charged as ``held_bytes``), the items frame with
    the plain codec, and the regular blob is the reference's, byte for
    byte."""
    port = pl.legacy_wire_pipelines(F.two_way_quantization("blockwise8", device=CPU),
                                    F.two_way_quantization("blockwise8", device=CPU), CPU)
    ref = ref_pl.legacy_wire_pipelines(RF.two_way_quantization("blockwise8"),
                                       RF.two_way_quantization("blockwise8"))
    for hop in ("task_data", "task_result"):
        assert [s.name for s in port[hop].stages] == [s.name for s in ref[hop].stages]
        pm, rm = _msgs(_payload(8), {"client": "site-1", "round": 2})
        pmsg, pctx = port[hop].begin_encode(pm)
        rmsg, rctx = ref[hop].begin_encode(rm)
        assert pctx.state["held_bytes"] == rctx.state["held_bytes"] > 0
        assert port[hop].encode_blob(pmsg, pctx) == ref[hop].encode_blob(rmsg, rctx)
    plain = pl.WirePipeline([], device=CPU)
    assert plain.begin_encode(_msgs(_payload(8))[0])[1].state["held_bytes"] == 0


def test_decode_blob_and_ingress_filter_recover_the_payload():
    """A regular blob decodes item by item through ``decode_blob``; the
    ingress adapter then dequantizes, and the values equal the
    reference's decode of the same blob."""
    port = pl.legacy_wire_pipelines(F.two_way_quantization("nf4", device=CPU),
                                    F.two_way_quantization("nf4", device=CPU), CPU)["task_data"]
    ref = ref_pl.legacy_wire_pipelines(RF.two_way_quantization("nf4"),
                                       RF.two_way_quantization("nf4"))["task_data"]
    pm, rm = _msgs(_payload(9), {"round": 0}, kind="task_data")
    pmsg, pctx = port.begin_encode(pm)
    blob = port.encode_blob(pmsg, pctx)
    outs = []
    for p, kind in ((port, MessageKind.TASK_DATA), (ref, RefKind.TASK_DATA)):
        dec = p.decoder()
        dec.decode_blob(blob)
        outs.append(dec.finish(kind))
    got, want = outs
    assert list(got.payload) == list(want.payload) == list(_payload(9))
    assert "quantized_fmt" not in got.headers and got.headers == want.headers
    for name, value in want.payload.items():
        _bitwise(got.payload[name], value)


def _lsq_executor(name, seed, w_true, cls, n=128, local_steps=3):
    """A least-squares client in numpy, the same in both packages."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, w_true.size)).astype(np.float32)
    y = X @ w_true

    def train_fn(params, rnd):
        w = _np(params["w"]).astype(np.float32)
        for _ in range(local_steps):
            w = w - np.float32(0.3) * (X.T @ (X @ w - y) / np.float32(n))
        return {"w": w}, n, {}

    return cls(name, train_fn)


@pytest.mark.parametrize("transmission", ["regular", "container"])
def test_filterchain_shim_matches_pipeline_and_reference_bitwise(transmission):
    """The reference's shim-equivalence case (test_pipeline.py) in the
    port: the two-way filter configuration and the equivalent per-item
    pipeline train to bitwise-identical weights, which also equal the
    reference's, with the same wire bytes."""
    w_true = np.arange(1, 9, dtype=np.float32) / 8.0
    cfg = dict(num_rounds=4, transmission=transmission, chunk_size=2048)

    def run_port(wire_kwargs):
        sim = FLSimulator([_lsq_executor(f"site-{i}", i, w_true, TrainExecutor)
                           for i in range(3)], FedAvgAggregator(device=CPU),
                          SimulationConfig(**cfg), device=CPU, **wire_kwargs)
        return sim.run({"w": np.zeros(8, np.float32)}), sim.stats.bytes_sent

    filters = F.two_way_quantization("blockwise8", device=CPU)
    legacy, legacy_bytes = run_port({"server_filters": filters, "client_filters": filters})
    stack = ["quantize:blockwise8"]
    new, _ = run_port({"pipelines": {"task_data": pl.build_pipeline(stack, device=CPU),
                                     "task_result": pl.build_pipeline(stack, device=CPU)}})
    _bitwise(legacy["w"], _np(new["w"]))
    ref_filters = RF.two_way_quantization("blockwise8")
    ref_sim = RefSimulator([_lsq_executor(f"site-{i}", i, w_true, RefExecutor)
                            for i in range(3)], RefFedAvg(), RefConfig(**cfg),
                           server_filters=ref_filters, client_filters=ref_filters)
    want = ref_sim.run({"w": np.zeros(8, np.float32)})
    _bitwise(legacy["w"], want["w"])
    assert legacy_bytes == ref_sim.stats.bytes_sent


def test_simulator_refuses_filters_with_pipelines_and_ingress_filters_with_streaming():
    ex = [_lsq_executor("s0", 0, np.ones(4, np.float32), TrainExecutor)]
    with pytest.raises(ValueError, match="not both"):
        FLSimulator(ex, FedAvgAggregator(device=CPU), SimulationConfig(),
                    server_filters=F.no_filters(), pipelines={"task_data": None},
                    device=CPU)
    filters = F.two_way_quantization("blockwise8", device=CPU)
    with pytest.raises(ValueError, match="legacy server-ingress filter"):
        FLSimulator(ex, FedAvgAggregator(device=CPU), SimulationConfig(),
                    server_filters=filters, client_filters=filters,
                    server_streaming_agg=True, device=CPU)
