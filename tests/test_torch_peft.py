"""Port parity, the LoRA plane: the ``lowrank`` wire kind, the truncated
SVD (``ops.low_rank_decompose`` / ``low_rank_merge``), the ``lora`` stage,
``LoRAFedAvgAggregator`` and the native adapters, each against the
reference on inputs made from a seed with numpy.

Tolerances:

* Wire bytes of a factor pair are bitwise the reference's **given the
  same factors**; both packages' SVDs (LAPACK through jax, LAPACK through
  torch) agree only numerically, so factors made by each are compared
  within a tolerance.
* Factors on a matrix with a separated spectrum (singular values 64 ..
  36, then 1 and below; gap 35): within 1e-5 of the largest factor
  entry. LAPACK's backward error is a few eps of ``||x||``, and the
  singular subspaces move by it over the gap (Davis–Kahan).
* Fidelity ``||x - a b||_F`` on Gaussian matrices equal within 1e-6
  relative: the optimum is flat in the factors, so it is far less
  sensitive than the factors themselves (readings ~1e-7).
* A merge ``(a @ b) * s`` of total rank k: each element within
  ``2 k eps (|a| @ |b|) |s|`` of the reference's (the error of a
  length-k fp32 dot product summed in another order, eps = 2^-24).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import serialization as ref_ser  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.core.quantization import quantize as ref_quantize  # noqa: E402
from repro.fl import aggregator as ref_agg  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.peft.lowrank import LowRankDelta as RefLowRankDelta  # noqa: E402
from repro.utils.mem import MemoryMeter as RefMemoryMeter  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.core.quantization import quantize  # noqa: E402
from repro_torch.fl import aggregator as port_agg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.peft.lowrank import LowRankDelta  # noqa: E402
from repro_torch.peft.stage import LoRAStage  # noqa: E402
from repro_torch.utils.mem import MemoryMeter  # noqa: E402
from repro_torch.utils.trees import from_reference_items  # noqa: E402

EPS = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_pool():
    """One thread in torch's intra-op pool and in scipy's OpenBLAS pool
    (the reference's SVDs run there) for this file's tests. Two SVD
    federations at once on a shared 8-core CPU host, each with a pool
    per core, took 170-238 s each against 2.7-8.4 s alone.
    The cap reaches OpenBLAS only once ``scipy.linalg`` has loaded it,
    hence the import first. The arithmetic is the same either way."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        import scipy.linalg  # noqa: F401
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    with limits:
        yield
    torch.set_num_threads(before)


def _pair(seed=0, m=40, n=24, rank=4, alpha=None):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, rank)).astype(np.float32)
    b = rng.standard_normal((rank, n)).astype(np.float32)
    alpha = 2.0 * rank if alpha is None else alpha
    return (RefLowRankDelta(a, b, alpha, rank, (m, n), np.float32),
            LowRankDelta(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()),
                         alpha, rank, (m, n), np.dtype(np.float32)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the lowrank wire kind
# ---------------------------------------------------------------------------

def test_lowrank_item_bytes_equal_the_reference():
    ref_d, port_d = _pair()
    blob = ser.serialize_item("w", port_d)
    assert blob == ref_ser.serialize_item("w", ref_d)
    assert ser.declared_item_nbytes(blob) == ref_ser.declared_item_nbytes(blob) == len(blob)
    # a stacked tensor's factors (leading dims collapsed) and another alpha
    ref_d, port_d = _pair(seed=1, m=3 * 16, n=8, rank=2, alpha=5.0)
    ref_d.orig_shape = port_d.orig_shape = (3, 16, 8)
    assert ser.serialize_item("s", port_d) == ref_ser.serialize_item("s", ref_d)


@pytest.mark.parametrize("path", ["contiguous", "segments"])
def test_lowrank_decodes_both_ways_bitwise(path):
    """Each package decodes the other's bytes to the same factors and
    metadata, from one buffer and from three segment views."""
    ref_d, port_d = _pair(seed=2)

    def split(blob):
        if path == "contiguous":
            return memoryview(blob)
        c1, c2 = len(blob) // 3, 2 * len(blob) // 3
        return [memoryview(blob)[:c1], memoryview(blob)[c1:c2], memoryview(blob)[c2:]]

    blob = ser.serialize_item("w", port_d)
    name, ref_out, used = ref_ser.deserialize_item(split(blob))
    assert (name, used) == ("w", len(blob)) and isinstance(ref_out, RefLowRankDelta)
    name, port_out, used = ser.deserialize_item(split(ref_ser.serialize_item("w", ref_d)))
    assert (name, used) == ("w", len(blob)) and isinstance(port_out, LowRankDelta)
    for got, want in ((port_out, ref_d), (ref_out, port_d)):
        _same_bits(got.a, _np(want.a))
        _same_bits(got.b, _np(want.b))
        assert (got.alpha, got.rank, tuple(got.orig_shape)) == \
            (want.alpha, want.rank, tuple(want.orig_shape))
        assert np.dtype(got.orig_dtype) == np.dtype(want.orig_dtype)
    assert port_out.total_bytes == ref_d.total_bytes and port_out.scale == ref_d.scale


def test_to_dense_within_the_merge_bound():
    ref_d, port_d = _pair(seed=3, m=12, n=6, rank=2, alpha=4.0)
    ref_d.orig_shape = port_d.orig_shape = (3, 4, 6)
    want = np.asarray(ref_d.to_dense())
    got = port_d.to_dense()
    assert got.shape == (3, 4, 6) and got.dtype == torch.float32
    bound = 2 * 2 * EPS * (np.abs(ref_d.a) @ np.abs(ref_d.b)).reshape(3, 4, 6) * 2.0
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert port_d.dense_bytes == ref_d.dense_bytes == 3 * 4 * 6 * 4


# ---------------------------------------------------------------------------
# the truncated SVD
# ---------------------------------------------------------------------------

def _separated(m, n, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.concatenate([np.linspace(64, 36, 8), np.linspace(1.0, 0.01, n - 8)])
    return ((u * s) @ v.T).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 64), (64, 160)])
def test_decompose_factors_match_the_reference(shape):
    x = _separated(*shape) if shape[0] >= shape[1] else _separated(*shape[::-1]).T.copy()
    a, b = ops.low_rank_decompose(torch.from_numpy(x), 8)
    ra, rb = (np.asarray(t) for t in ref_ops.low_rank_decompose(x, 8))
    assert a.shape == ra.shape and b.shape == rb.shape
    assert a.dtype == b.dtype == torch.float32
    # the same canonical signs, so the factors agree entry for entry
    assert np.abs(a.numpy() - ra).max() <= 1e-5 * np.abs(ra).max()
    assert np.abs(b.numpy() - rb).max() <= 1e-5 * np.abs(rb).max()


@pytest.mark.parametrize("shape", [(512, 256), (256, 384), (1024, 256)])
def test_decompose_fidelity_equals_the_reference(shape):
    """Eckart–Young: ``||x - a b||_F`` is the discarded singular mass in
    both packages, on Gaussian matrices (a small spectral gap)."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    a, b = ops.low_rank_decompose(torch.from_numpy(x), 8)
    ra, rb = (np.asarray(t, np.float64) for t in ref_ops.low_rank_decompose(x, 8))
    x64 = x.astype(np.float64)
    got = np.linalg.norm(x64 - a.double().numpy() @ b.double().numpy())
    want = np.linalg.norm(x64 - ra @ rb)
    s = np.linalg.svd(x64, compute_uv=False)
    assert abs(got - want) <= 1e-6 * want
    assert abs(got - np.sqrt((s[8:] ** 2).sum())) <= 1e-6 * want


def test_decompose_signs_are_canonical_and_deterministic():
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((128, 96)).astype(np.float32))
    a, b = ops.low_rank_decompose(x, 8)
    a2, b2 = ops.low_rank_decompose(x.clone(), 8)
    _same_bits(a, a2.numpy())
    _same_bits(b, b2.numpy())
    # the first largest-|b| entry of each row is positive; flipping x's
    # sign moves the sign into a, not b
    rows = torch.arange(8)
    assert (b[rows, b.abs().argmax(dim=1)] > 0).all()
    na, nb = ops.low_rank_decompose(-x, 8)
    assert torch.allclose(nb, b, atol=1e-5) and torch.allclose(na, -a, atol=1e-4)


def test_decompose_rejects_what_the_reference_rejects():
    x = torch.zeros((6, 4))
    for bad, match in (((x, 0), "rank >= 1"), ((x, 5), "exceeds"),
                       ((torch.zeros(8), 2), "2-D")):
        with pytest.raises(ValueError, match=match):
            ops.low_rank_decompose(*bad)
        with pytest.raises(ValueError, match=match):
            ref_ops.low_rank_decompose(np.asarray(bad[0]), bad[1])


def test_merge_within_the_bound():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((70, 24)).astype(np.float32)
    b = rng.standard_normal((24, 50)).astype(np.float32)
    inv = np.float32(1.0) / np.float32(7.0)
    want = np.asarray(ref_ops.low_rank_merge(a, b, inv))
    got = ops.low_rank_merge(torch.from_numpy(a), torch.from_numpy(b), inv).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= 2 * 24 * EPS * (np.abs(a) @ np.abs(b)) * inv).all()


# ---------------------------------------------------------------------------
# the lora stage
# ---------------------------------------------------------------------------

SHAPES = [(2, 256), (16, 2048), (64, 64), (8, 8), (4096,), (32, 7), (7, 32),
          (2, 256, 256), (40, 24), (9, 9)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stage_eligibility_equals_the_reference(shape):
    """Stacked norms: ``(2, 256)`` (smoke width) is skipped at rank 8
    (8 > min(2, 256)); ``(16, 2048)`` (full width) is decomposed."""
    ref_stage = ref_pl.build_stage("lora:8")
    port_stage = pl.build_stage("lora:8")
    x = np.zeros(shape, np.float32)
    want = ref_stage._eligible(x)
    assert port_stage._eligible(x) == want
    assert port_stage._eligible(torch.from_numpy(x)) == want
    assert not port_stage._eligible(torch.zeros(shape, dtype=torch.int32))
    if shape in ((2, 256), (16, 2048)):
        assert want == (shape == (16, 2048))


def test_stage_spec_forms():
    assert isinstance(pl.build_stage("lora"), LoRAStage)
    s = pl.build_stage({"stage": "lora", "rank": 4, "alpha": 16, "min_params": 4096})
    assert (s.rank, s.alpha, s.min_params) == (4, 16.0, 4096)
    assert pl.build_stage("lora:16").rank == 16 and pl.build_stage("lora:16").alpha == 16.0
    with pytest.raises(ValueError, match="rank >= 1"):
        pl.build_stage("lora:0")


def _sd(seed=7):
    rng = np.random.default_rng(seed)
    return {
        "embed.w": rng.standard_normal((96, 64)).astype(np.float32),
        "layers.0.attn.wq": rng.standard_normal((64, 64)).astype(np.float32),
        "layers.0.norm": rng.standard_normal((64,)).astype(np.float32),
        "stacked": rng.standard_normal((2, 32, 48)).astype(np.float32),
        "step": np.asarray(123, np.int32),
    }


def _encode(p, sd, headers, kind=MessageKind.TASK_RESULT, cls=Message):
    msg, ctx = p.begin_encode(cls(kind, dict(sd), dict(headers)))
    return msg, ctx, [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


def test_stage_envelopes_match_the_reference_but_the_factors():
    """Same headers, same vmeta, same lengths, same passthrough bytes; the
    factor bytes are each package's own SVD (within the factor bound)."""
    headers = {"client": "site-1", "round": 2, "num_samples": 5}
    msg, ctx, port_items = _encode(pl.build_pipeline(["lora:8"], device="cpu"), _sd(), headers)
    rmsg, rctx, ref_items = _encode(ref_pl.build_pipeline(["lora:8"]), _sd(), headers,
                                    RefKind.TASK_RESULT, RefMessage)
    assert ctx.headers["lora_rank"] == rctx.headers["lora_rank"] == 8
    assert [len(b) for b in port_items] == [len(b) for b in ref_items]
    dec = pl.build_pipeline(["lora:8"], decode_values=False, device="cpu").decoder()
    rdec = ref_pl.build_pipeline(["lora:8"], decode_values=False).decoder()
    for pb, rb in zip(port_items, ref_items):
        name, got, _ = dec.decode_item(pb)
        _, want, _ = rdec.decode_item(rb)
        if isinstance(want, RefLowRankDelta):
            assert name in ("embed.w", "layers.0.attn.wq", "stacked")
            hlen = int.from_bytes(pb[:4], "little")
            assert pb[:4 + hlen] == rb[:4 + hlen]                   # envelope header
            ihlen = int.from_bytes(pb[4 + hlen:8 + hlen], "little")
            assert pb[4 + hlen:8 + hlen + ihlen] == rb[4 + hlen:8 + hlen + ihlen]  # item header
            for f in ("a", "b"):
                g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
                assert g.shape == w.shape
            x = _sd()[name].reshape(-1, _sd()[name].shape[-1]).astype(np.float64)
            fid = np.linalg.norm(x - _np(got.a).astype(np.float64) @ _np(got.b))
            rfid = np.linalg.norm(x - np.asarray(want.a, np.float64) @ np.asarray(want.b))
            assert abs(fid - rfid) <= 1e-6 * rfid
        else:
            assert pb == rb, name


def test_stage_round_trips_through_the_wire_and_resets_headers():
    sd = _sd()
    p = pl.build_pipeline(["lora:8", "crc32"], device="cpu")
    msg, ctx, items = _encode(p, sd, {"num_samples": 3})
    dec = p.decoder()
    for blob in items:
        dec.on_item(*dec.decode_item(blob)[:2])
    out = dec.finish(MessageKind.TASK_RESULT)
    assert "lora_rank" not in out.headers
    for name in ("embed.w", "layers.0.attn.wq", "stacked"):
        x = sd[name]
        a, b = ops.low_rank_decompose(torch.from_numpy(x.reshape(-1, x.shape[-1])), 8)
        assert out.payload[name].shape == x.shape
        assert torch.equal(out.payload[name], ops.low_rank_merge(a, b, 1.0).reshape(x.shape))
    for name in ("layers.0.norm", "step"):
        _same_bits(out.payload[name], sd[name])


def test_lora_encode_is_deterministic():
    """Same payload -> the same wire bytes, from fresh pipelines (the
    async double encode's contract)."""
    stack = ["lora:8", "quantize:nf4", "crc32"]
    first = _encode(pl.build_pipeline(stack, device="cpu"), _sd(), {"round": 1})[2]
    second = _encode(pl.build_pipeline(stack, device="cpu"), _sd(), {"round": 1})[2]
    assert first == second


def test_wire_form_guards_pass_lowrank_items_through():
    """Every value stage that the reference guards with ``_is_quantizable``
    or ``_is_plain_float`` leaves a factor pair as it is."""
    _, d = _pair(seed=4)
    ctx = pl.WireContext({"client": "c", "round": 0}, device="cpu")
    for spec in ("quantize:nf4", "ef-quantize:blockwise8", "delta",
                 {"stage": "dp-noise", "sigma": 0.1},
                 {"stage": "secure-mask", "client_index": 0, "all_clients": [0, 1]},
                 "topk:0.1", "lora:2"):
        assert pl.build_stage(spec).encode_item("w", d, ctx) is d


# ---------------------------------------------------------------------------
# LoRAFedAvgAggregator
# ---------------------------------------------------------------------------

def _client_payloads(n_clients=4, rank=8):
    out = []
    for i in range(n_clients):
        rng = np.random.default_rng(100 + i)
        u = rng.standard_normal((64, rank)).astype(np.float32)
        v = rng.standard_normal((rank, 48)).astype(np.float32)
        a, b = (np.asarray(t) for t in ref_ops.low_rank_decompose(u @ v, rank))
        norm = rng.standard_normal(32).astype(np.float32)
        bias = rng.standard_normal(4096 + 16).astype(np.float32)
        ref_payload = {"wq": RefLowRankDelta(a, b, float(rank + i), rank, (64, 48), np.float32),
                       "norm": norm, "bias": ref_quantize(bias, "nf4")}
        port_payload = from_reference_items({"wq": ref_payload["wq"], "norm": norm}, "cpu")
        port_payload["bias"] = quantize(torch.from_numpy(bias), "nf4")
        out.append((ref_payload, port_payload, {"num_samples": 2 + i, "client": f"site-{i}"}))
    return out


def _fold(agg, payloads, which):
    for ref_p, port_p, headers in payloads:
        payload = ref_p if which == "ref" else port_p
        w = agg.weight_of(headers)
        for name, value in payload.items():
            agg.accept_item(name, value, w)
        agg.begin(headers)
    return agg


def test_lora_fedavg_scaled_factors_bitwise_and_mean_within_bound():
    payloads = _client_payloads()
    ref = _fold(ref_agg.LoRAFedAvgAggregator(), payloads, "ref")
    port = _fold(port_agg.build_aggregator("lora-fedavg", device="cpu"), payloads, "port")
    assert port.consumes_wire and port.accepted == ref.accepted == 4
    assert port._weight == ref._weight
    for got, want in zip(port._a["wq"], ref._a["wq"]):
        _same_bits(got, want)                       # a * f32(weight * alpha/rank)
    for got, want in zip(port._b["wq"], ref._b["wq"]):
        _same_bits(got, want)
    a_cat, b_cat = np.concatenate(ref._a["wq"], 1), np.concatenate(ref._b["wq"], 0)
    inv = np.float32(1.0) / np.float32(ref._weight)
    want, got = ref.finish(), port.finish()
    assert list(got) == list(want) == ["wq", "norm", "bias"]
    bound = 2 * a_cat.shape[1] * EPS * (np.abs(a_cat) @ np.abs(b_cat)) * inv
    assert (np.abs(got["wq"].numpy() - want["wq"]) <= bound).all()
    _same_bits(got["norm"], want["norm"])           # plain FedAvg, numpy's arithmetic
    _same_bits(got["bias"], want["bias"])           # nf4 dequantized, then folded


def test_lora_fedavg_mixed_ranks():
    """Ranks 4, 8 and 16 concatenate along the rank axis, in acceptance order."""
    ref, port = ref_agg.LoRAFedAvgAggregator(), port_agg.LoRAFedAvgAggregator(device="cpu")
    for i, rank in enumerate((4, 8, 16)):
        rng = np.random.default_rng(i)
        u = rng.standard_normal((32, rank)).astype(np.float32)
        v = rng.standard_normal((rank, 24)).astype(np.float32)
        a, b = (np.asarray(t) for t in ref_ops.low_rank_decompose(u @ v, rank))
        d = RefLowRankDelta(a, b, float(rank), rank, (32, 24), np.float32)
        for agg, item in ((ref, d), (port, from_reference_items({"w": d}, "cpu")["w"])):
            agg.accept_item("w", item, 1.0 + i)
            agg.begin({"num_samples": 1 + i})
    a_cat, b_cat = np.concatenate(ref._a["w"], 1), np.concatenate(ref._b["w"], 0)
    assert a_cat.shape == (32, 28) and port._a["w"][2].shape == (32, 16)
    inv = np.float32(1.0) / np.float32(6.0)
    want, got = ref.finish()["w"], port.finish()["w"].numpy()
    assert (np.abs(got - want) <= 2 * 28 * EPS * (np.abs(a_cat) @ np.abs(b_cat)) * inv).all()


def test_lora_fedavg_shape_conflict_rejected():
    agg = port_agg.LoRAFedAvgAggregator(device="cpu")
    agg.accept_item("w", _pair(m=16, n=8, rank=2)[1], 1.0)
    with pytest.raises(ValueError, match="shape"):
        agg.accept_item("w", _pair(m=8, n=16, rank=2)[1], 1.0)


def test_lora_fedavg_resets_after_finish():
    payloads = _client_payloads(2)
    agg = port_agg.LoRAFedAvgAggregator(device="cpu")
    first = _fold(agg, payloads, "port").finish()
    assert agg.accepted == 0 and agg._weight == 0.0 and not agg._a and not agg._plain_names
    second = _fold(agg, payloads, "port").finish()
    for k in first:
        _same_bits(first[k], second[k].numpy())


def _stream(agg, sd, client, pipeline, sm_mod, msg_cls, kind):
    msg = msg_cls(kind, dict(sd), {"num_samples": 1, "client": client})
    enc, ctx = pipeline.begin_encode(msg)
    dec = pipeline.decoder(sink=agg)
    recv = sm_mod.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item)
    driver = sm_mod.LoopbackDriver()
    driver.connect(recv.on_chunk)
    sm_mod.ContainerStreamer(driver, 1 << 16).send_items(
        pipeline.iter_encode_views(enc, ctx), pipeline.n_items(enc))
    dec.finish(msg.kind, pipeline.unsent_headers(enc))


def _fold_peak(dim, package, clients=4):
    rng = np.random.default_rng(0)
    payloads = [{"w": rng.standard_normal((dim, dim)).astype(np.float32)}
                for _ in range(clients)]
    if package == "ref":
        agg, meter = ref_agg.LoRAFedAvgAggregator(), RefMemoryMeter()
        p = ref_pl.build_pipeline(["lora:8"], decode_values=False)
        args = (p, ref_sm, RefMessage, RefKind.TASK_RESULT)
    else:
        agg, meter = port_agg.LoRAFedAvgAggregator(device="cpu"), MemoryMeter()
        p = pl.build_pipeline(["lora:8"], decode_values=False, device="cpu")
        args = (p, sm, Message, MessageKind.TASK_RESULT)
    with meter.activate():
        for i, sd in enumerate(payloads):
            _stream(agg, sd, f"site-{i}", *args)
    agg.finish()
    return meter.peak


def test_fold_peak_is_o_rank_dim_and_the_references():
    """The server's MemoryMeter peak over a streamed lora fold is the
    reference's to the byte, far below one dense model, and grows
    sub-quadratically with the matrix width."""
    small, large = 128, 512
    peaks = {dim: _fold_peak(dim, "port") for dim in (small, large)}
    assert peaks == {dim: _fold_peak(dim, "ref") for dim in (small, large)}
    assert peaks[large] < 4 * large * large / 8
    assert peaks[large] < peaks[small] * (large / small) ** 2 / 2


def test_job_spec_keeps_the_uplink_in_wire_form():
    from repro_torch.fl.job import build_pipelines_from_spec

    spec = {"pipeline": {"task_result_out": ["lora:8", "crc32"]}, "aggregator": "lora-fedavg"}
    pls = build_pipelines_from_spec(spec, device="cpu")
    assert pls["task_result"].decode_values is False and pls["task_data"].decode_values
    assert port_agg.aggregator_consumes_wire("lora-fedavg") is True
    assert port_agg.aggregator_consumes_wire({"aggregator": "lora-fedavg"}) is True
    assert port_agg.NOT_PORTED_AGGREGATORS == ()
    assert port_agg.registered_aggregators() == ref_agg.registered_aggregators()


# ---------------------------------------------------------------------------
# native adapters
# ---------------------------------------------------------------------------

def _spec(mod):
    return {"attn": {"wq": mod.ParamDef((64, 64), (None, None)), "norm": mod.norm_spec(64)},
            "mlp": {"w_up": mod.ParamDef((64, 128), (None, None)),
                    "w_stack": mod.ParamDef((2, 64, 64), (None, None, None))}}


def test_lora_adapter_spec_equals_the_reference():
    got = L.lora_adapter_spec(_spec(L), 4)
    want = ref_layers.lora_adapter_spec(_spec(ref_layers), 4)
    assert set(got) == set(want) == {"attn", "mlp"}
    for mod in ("attn", "mlp"):
        assert set(got[mod]) == set(want[mod])
        for k in got[mod]:
            for f in ("a", "b"):
                g, w = got[mod][k][f], want[mod][k][f]
                assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init)


def test_lora_adapter_params_and_merge():
    gen = torch.Generator().manual_seed(0)
    adapters = L.lora_adapter_params(gen, _spec(L), rank=4)
    ref_adapters = ref_layers.lora_adapter_params(jax.random.PRNGKey(0), _spec(ref_layers), 4)
    assert list(adapters) == list(ref_adapters) == ["attn/wq", "mlp/w_up"]
    d = adapters["mlp/w_up"]
    assert isinstance(d, LowRankDelta) and (d.rank, d.alpha, d.orig_shape) == (4, 4.0, (64, 128))
    assert d.a.shape == (64, 4) and 0.01 < float(d.a.std()) < 0.03   # normal * 0.02
    assert torch.equal(d.to_dense(), torch.zeros(64, 128))           # b starts at zero
    # merge the reference's factors, trained (b non-zero), into the same base
    rng = np.random.default_rng(1)
    base = rng.standard_normal((64, 64)).astype(np.float32)
    r = ref_adapters["attn/wq"]
    trained = RefLowRankDelta(np.asarray(r.a), rng.standard_normal((4, 64)).astype(np.float32),
                              r.alpha, r.rank, r.orig_shape, r.orig_dtype)
    want = ref_layers.merge_lora({"w": base, "n": np.zeros(3)}, {"w": trained})
    got = L.merge_lora({"w": torch.from_numpy(base), "n": torch.zeros(3)},
                       from_reference_items({"w": trained}, "cpu"))
    assert torch.equal(got["n"], torch.zeros(3))
    bound = 2 * 4 * EPS * (np.abs(trained.a) @ np.abs(trained.b)) + EPS * np.abs(want["w"])
    assert (np.abs(got["w"].numpy() - want["w"]) <= bound).all()


def test_native_adapters_ship_and_aggregate_like_the_reference():
    """Adapter payloads (no lora stage) cross the wire as ``lowrank``
    items, bitwise the reference's envelopes, and fold alike."""
    spec = {"wq": ref_layers.ParamDef((48, 32), (None, None))}
    ref = ref_agg.LoRAFedAvgAggregator()
    port = port_agg.LoRAFedAvgAggregator(device="cpu")
    for i in range(3):
        d = ref_layers.lora_adapter_params(jax.random.PRNGKey(i), spec, rank=4)["wq"]
        trained = RefLowRankDelta(
            np.asarray(d.a), np.random.default_rng(i).standard_normal((4, 32)).astype(np.float32),
            d.alpha, d.rank, d.orig_shape, d.orig_dtype)
        headers = {"num_samples": 1, "client": f"site-{i}"}
        rp = ref_pl.build_pipeline(["crc32"], decode_values=False)
        pp = pl.build_pipeline(["crc32"], decode_values=False, device="cpu")
        ref_bytes = _encode(rp, {"wq": trained}, headers, RefKind.TASK_RESULT, RefMessage)[2]
        port_bytes = _encode(pp, from_reference_items({"wq": trained}, "cpu"), headers)[2]
        assert port_bytes == ref_bytes
        _stream(ref, {"wq": trained}, headers["client"], rp, ref_sm, RefMessage,
                RefKind.TASK_RESULT)
        _stream(port, from_reference_items({"wq": trained}, "cpu"), headers["client"], pp,
                sm, Message, MessageKind.TASK_RESULT)
    a_cat, b_cat = np.concatenate(ref._a["wq"], 1), np.concatenate(ref._b["wq"], 0)
    want, got = ref.finish()["wq"], port.finish()["wq"].numpy()
    inv = np.float32(1.0) / np.float32(3.0)
    assert (np.abs(got - want) <= 2 * 12 * EPS * (np.abs(a_cat) @ np.abs(b_cat)) * inv).all()
