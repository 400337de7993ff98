"""Port parity, secure aggregation: ``repro_torch.core.secure_agg`` and the
``secure-mask`` stage against ``repro.core.secure_agg`` and the
reference's stage, on the same numpy inputs in one process.

Every result here is bitwise: the fixed-point grid (float64 product,
round half to even, mod 2**32), each client pair's masks (the
reference's own numpy generator, seeded by ``_pair_seed``), the masked
``uint32`` grids, the wire envelopes of the stage, and the unmasked mean
``SecureAggregator.finish`` decodes. The masks cancel exactly, a missing
client fails closed, streams cross-decode between the packages, and
``SecureMaskFilter`` is one of the stateless filters in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import secure_agg as ref_sa  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.fl import FLSimulator as RefSimulator  # noqa: E402
from repro.fl import SimulationConfig as RefConfig  # noqa: E402
from repro.fl import TrainExecutor as RefExecutor  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import secure_agg as sa  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.core.quantization import quantize  # noqa: E402
from repro_torch.fl.executor import TrainExecutor  # noqa: E402
from repro_torch.fl.simulator import FLSimulator, SimulationConfig  # noqa: E402

CLIENTS = [0, 1, 2]


def _payloads(seed: int = 0) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [{
        "w": (rng.standard_normal((33, 17)) * (i + 1)).astype(np.float32),
        "b": rng.standard_normal((257,)).astype(np.float32),
        "steps": np.arange(5, dtype=np.int32) + i,     # not a float: passes through
    } for i in CLIENTS]


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _bitwise(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_constants_match_the_reference():
    assert sa.MOD == int(ref_sa.MOD) == 2**32
    assert sa.SCALE == ref_sa.SCALE


def test_grid_round_trip_is_bitwise():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 100,
        # exact halves of a grid step: round half to even on both sides
        (np.arange(-8, 8, dtype=np.float32) + 0.5) / np.float32(sa.SCALE),
        np.array([0.0, -0.0, 32767.99, -32768.0, 1e-30, -1e-30], np.float32),
    ])
    g = sa._to_grid(torch.from_numpy(x))
    assert g.dtype == torch.int64
    _bitwise(g, ref_sa._to_grid(x))
    _bitwise(sa._from_grid(g), ref_sa._from_grid(ref_sa._to_grid(x)))
    # recentring: values at and past 2**31 come back negative
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.int64)
    _bitwise(sa._from_grid(torch.from_numpy(edge)), ref_sa._from_grid(edge))


def test_every_pair_mask_stream_matches_the_reference():
    for base_seed in (0, 42):
        for i in CLIENTS:
            for j in CLIENTS:
                if i == j:
                    continue
                for name, rnd in (("w", 0), ("b", 3)):
                    want = ref_sa._pair_seed(base_seed, i, j, name, rnd).integers(
                        0, int(ref_sa.MOD), size=(64,), dtype=np.int64)
                    got = sa._pair_seed(base_seed, i, j, name, rnd).integers(
                        0, sa.MOD, size=(64,), dtype=np.int64)
                    _bitwise(got, want)
                    # the pair shares one stream whichever side draws it
                    _bitwise(sa._pair_seed(base_seed, j, i, name, rnd).integers(
                        0, sa.MOD, size=(64,), dtype=np.int64), want)


@pytest.mark.parametrize("rnd", [0, 2])
def test_mask_filter_output_is_bitwise_the_reference(rnd):
    for i, payload in zip(CLIENTS, _payloads()):
        headers = {"round": rnd, "num_samples": 4}
        want = ref_sa.SecureMaskFilter(i, CLIENTS, base_seed=9).process(
            RefMessage(RefKind.TASK_RESULT, dict(payload), dict(headers)))
        got = sa.SecureMaskFilter(i, CLIENTS, base_seed=9, device="cpu").process(
            Message(MessageKind.TASK_RESULT, {k: torch.from_numpy(v.copy())
                                              for k, v in payload.items()}, dict(headers)))
        assert got.headers == want.headers and got.headers["secure_masked"] is True
        assert list(got.payload) == list(want.payload)
        for name, w in want.payload.items():
            _bitwise(got.payload[name], w)
        assert got.payload["w"].dtype == torch.uint32


def test_masks_cancel_exactly():
    payloads = _payloads(1)
    masked = [sa.SecureMaskFilter(i, CLIENTS, base_seed=5, device="cpu").process(
        Message(MessageKind.TASK_RESULT, dict(p), {"round": 1})) for i, p in zip(CLIENTS, payloads)]
    for name in ("w", "b"):
        total = sum(m.payload[name].to(torch.int64) for m in masked) % sa.MOD
        plain = sum(sa._to_grid(torch.from_numpy(p[name])) for p in payloads) % sa.MOD
        assert torch.equal(total, plain), name
        # and no single masked grid is its plain grid
        assert not torch.equal(masked[0].payload[name].to(torch.int64),
                               sa._to_grid(torch.from_numpy(payloads[0][name])))


def test_secure_aggregator_finish_is_bitwise_the_reference():
    payloads = _payloads(2)
    ref_agg, port_agg = ref_sa.SecureAggregator(3), sa.SecureAggregator(3, device="cpu")
    for i, p in zip(CLIENTS, payloads):
        headers = {"round": 0, "num_samples": 3 + i}
        ref_agg.accept(ref_sa.SecureMaskFilter(i, CLIENTS).process(
            RefMessage(RefKind.TASK_RESULT, dict(p), dict(headers))))
        port_agg.accept(sa.SecureMaskFilter(i, CLIENTS, device="cpu").process(
            Message(MessageKind.TASK_RESULT, dict(p), dict(headers))))
    want, got = ref_agg.finish(), port_agg.finish()
    assert list(got) == list(want)
    for name in ("w", "b"):
        _bitwise(got[name], want[name])
        np.testing.assert_allclose(_np(got[name]), np.mean([p[name] for p in payloads], 0),
                                   atol=3.0 / sa.SCALE)
    # non-grid items pass through (the last client's), as in the reference
    _bitwise(got["steps"], want["steps"])


def test_missing_client_fails_closed():
    agg = sa.SecureAggregator(num_clients=3, device="cpu")
    agg.accept(sa.SecureMaskFilter(0, CLIENTS, device="cpu").process(
        Message(MessageKind.TASK_RESULT, {"w": np.ones(8, np.float32)}, {})))
    with pytest.raises(RuntimeError, match="needs all 3 clients"):
        agg.finish()
    with pytest.raises(ValueError, match="masked"):
        agg.accept(Message(MessageKind.TASK_RESULT, {"w": np.ones(8, np.float32)}, {}))


def test_mask_filter_is_stateless_in_both_packages():
    assert not ref_pl._filter_is_stateful(ref_sa.SecureMaskFilter(0, CLIENTS))
    assert not pl._filter_is_stateful(sa.SecureMaskFilter(0, CLIENTS, device="cpu"))
    assert "secure-mask" in pl.registered_stages()
    assert "secure-mask" not in pl.NOT_PORTED_STAGES
    assert pl.NOT_PORTED_STAGES == ()


def _stack(i):
    return [{"stage": "secure-mask", "client_index": i, "all_clients": CLIENTS,
             "base_seed": 11}, "crc32"]


HEADERS = {"client": "site-1", "round": 4, "num_samples": 8}


def _with_qtensor(payload):
    """The payload plus an already-quantized item, which the stage passes through."""
    return {**payload, "q": quantize(torch.linspace(-1, 1, 4096), "blockwise8")}


def test_stage_envelopes_are_bitwise_the_reference():
    for i, payload in zip(CLIENTS, _payloads(4)):
        ref_p, port_p = ref_pl.build_pipeline(_stack(i)), pl.build_pipeline(_stack(i),
                                                                            device="cpu")
        rmsg, rctx = ref_p.begin_encode(RefMessage(RefKind.TASK_RESULT, dict(payload),
                                                   dict(HEADERS)))
        pmsg, pctx = port_p.begin_encode(Message(MessageKind.TASK_RESULT,
                                                 _with_qtensor(payload), dict(HEADERS)))
        want = [ser.join_views(v) for _n, v in ref_p.iter_encode_views(rmsg, rctx)]
        got = [ser.join_views(v) for _n, v in port_p.iter_encode_views(pmsg, pctx)]
        assert rctx.headers["secure_masked"] is pctx.headers["secure_masked"] is True
        assert got[:-1] == want          # the meta item and every payload item
        assert b'"dtype": "uint32"' in got[1]
        assert b'"kind": "qtensor"' in got[-1]   # the quantized item passed through


def _send(encode_pipeline, message, on_chunk, streamer_mod):
    drv = streamer_mod.LoopbackDriver()
    drv.connect(on_chunk)
    msg, ctx = encode_pipeline.begin_encode(message)
    streamer_mod.ContainerStreamer(drv, 1024).send_items(
        encode_pipeline.iter_encode_views(msg, ctx), encode_pipeline.n_items(msg))


@pytest.mark.parametrize("direction", ["port_reads_reference", "reference_reads_port"])
def test_stage_streams_cross_decode(direction):
    """Each package's receiver (registry fallback: it knows the stage only
    from the envelope) decodes the other's masked stream to the same
    ``uint32`` grids, and the grids sum to the reference's mean."""
    ref_agg, port_agg = ref_sa.SecureAggregator(3), sa.SecureAggregator(3, device="cpu")
    for i, payload in zip(CLIENTS, _payloads(5)):
        if direction == "port_reads_reference":
            dec = pl.build_pipeline([], device="cpu").decoder()
            recv = sm.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item)
            _send(ref_pl.build_pipeline(_stack(i)),
                  RefMessage(RefKind.TASK_RESULT, dict(payload), dict(HEADERS)),
                  recv.on_chunk, ref_sm)
            got = dec.finish(MessageKind.TASK_RESULT)
            port_agg.accept(got)
            ref_agg.accept(ref_sa.SecureMaskFilter(i, CLIENTS, base_seed=11).process(
                RefMessage(RefKind.TASK_RESULT, dict(payload), dict(HEADERS))))
        else:
            dec = ref_pl.build_pipeline([]).decoder()
            recv = ref_sm.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item)
            _send(pl.build_pipeline(_stack(i), device="cpu"),
                  Message(MessageKind.TASK_RESULT, dict(payload), dict(HEADERS)),
                  recv.on_chunk, sm)
            got = dec.finish(RefKind.TASK_RESULT)
            ref_agg.accept(got)
            port_agg.accept(sa.SecureMaskFilter(i, CLIENTS, base_seed=11, device="cpu").process(
                Message(MessageKind.TASK_RESULT, dict(payload), dict(HEADERS))))
        assert got.headers["secure_masked"] is True
        assert _np(got.payload["w"]).dtype == np.uint32
    want, have = ref_agg.finish(), port_agg.finish()
    for name in ("w", "b"):
        _bitwise(have[name], want[name])


def test_secure_agg_through_the_simulator_is_bitwise_the_reference():
    """The reference's own full-stack check (masking as a per-client
    uplink stage, a streamed container wire, SecureAggregator on the
    server), run in both packages: the federation mean comes out bitwise
    equal, and within a few grid steps of the plain mean."""
    rng = np.random.default_rng(1)
    locals_ = [rng.standard_normal((64,)).astype(np.float32) for _ in CLIENTS]

    def train(i):
        return lambda params, rnd: ({"w": locals_[i]}, 1, {})

    ref_sim = RefSimulator([RefExecutor(f"site-{i}", train(i)) for i in CLIENTS],
                           ref_sa.SecureAggregator(3),
                           RefConfig(num_rounds=1, transmission="container", chunk_size=512))
    port_sim = FLSimulator([TrainExecutor(f"site-{i}", train(i)) for i in CLIENTS],
                           sa.SecureAggregator(3, device="cpu"),
                           SimulationConfig(num_rounds=1, transmission="container",
                                            chunk_size=512),
                           pipelines={}, device="cpu")
    for i, proxy in enumerate(ref_sim.controller.clients):
        proxy.pipelines = {**proxy.pipelines, "task_result": ref_pl.WirePipeline(
            [ref_pl.SecureMaskStage(i, CLIENTS)])}
    for i, proxy in enumerate(port_sim.controller.clients):
        proxy.pipelines = {**proxy.pipelines, "task_result": pl.WirePipeline(
            [pl.SecureMaskStage(i, CLIENTS)], device="cpu")}
    want = ref_sim.run({"w": np.zeros(64, np.float32)})
    got = port_sim.run({"w": torch.zeros(64)})
    _bitwise(got["w"], want["w"])
    assert port_sim.stats.as_dict() == ref_sim.stats.as_dict()
    np.testing.assert_allclose(_np(got["w"]), np.mean(locals_, 0), atol=3.0 / sa.SCALE)
