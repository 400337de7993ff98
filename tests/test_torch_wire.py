"""Port parity, wire level: the port's pipeline writes the reference's
bytes, and container streams cross-decode between the two packages.

The golden hashes and the ``_golden_sd`` / ``_stream_hash`` recipe are
copied from ``tests/test_wire_golden.py`` (sha256 over every envelope
of two rounds, length-prefixed), so the port is held to the same pinned
bytes as the reference — all four stacks, the nf4 ones with ``zlib``
and the stateful ``delta`` included.
"""
import hashlib
import json
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.core.quantization import QuantizedTensor  # noqa: E402

GOLDEN = {
    "nf4-delta-zlib-crc32": "31020ea62b809910e1d728215472111b1f5e9c7aad5c944ecf5e8bb039961809",
    "nf4-zlib-crc32": "9772001f25dab132f65cf410d40c6b0b6072a3f032f360ae9bb6fc60acc7baca",
    "blockwise8": "8f89d45f32e4db30467d7a05ffb189e862b9a8f062fa010f0596cdaa2c2b1379",
    "plain": "7c00654d6d6d40ca6aa6d5733aec3923028d62eba7d8428fc58bb56da5342869",
}

STACKS = {
    "nf4-delta-zlib-crc32": ["quantize:nf4", "delta", "zlib", "crc32"],
    "nf4-zlib-crc32": ["quantize:nf4", "zlib", "crc32"],
    "blockwise8": ["quantize:blockwise8"],
    "plain": [],
}

CROSS_STACK = ["quantize:blockwise8", "crc32"]
NF4_CROSS_STACK = ["quantize:nf4", "zlib", "crc32"]


def _golden_sd():
    rng = np.random.default_rng(42)
    return {
        "embed.w": rng.standard_normal((96, 64)).astype(np.float32),
        "layers.0.attn.wq": rng.standard_normal((64, 64)).astype(np.float32),
        "layers.0.norm": rng.standard_normal((64,)).astype(np.float32),
        "step": np.asarray(123, np.int32),
    }


def _stream_hash(pipeline, rounds=2):
    h = hashlib.sha256()
    for rnd in range(rounds):
        m = Message(MessageKind.TASK_RESULT, _golden_sd(),
                    {"client": "site-0", "round": rnd, "num_samples": 17})
        msg, ctx = pipeline.begin_encode(m)
        for _name, blob in pipeline.iter_encode(msg, ctx):
            h.update(len(blob).to_bytes(8, "little"))
            h.update(blob)
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_reproduces_golden_wire_bytes(name):
    assert _stream_hash(pl.build_pipeline(STACKS[name], device="cpu")) == GOLDEN[name]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_reproduces_golden_wire_bytes_from_tensors(name):
    """Torch tensors in the payload frame exactly like numpy arrays."""
    p = pl.build_pipeline(STACKS[name], device="cpu")
    h = hashlib.sha256()
    for rnd in range(2):
        sd = {k: torch.from_numpy(v) for k, v in _golden_sd().items()}
        msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, sd,
                                          {"client": "site-0", "round": rnd,
                                           "num_samples": 17}))
        for _name, blob in p.iter_encode(msg, ctx):
            h.update(len(blob).to_bytes(8, "little"))
            h.update(blob)
    assert h.hexdigest() == GOLDEN[name]


def _cross_sd():
    sd = _golden_sd()
    rng = np.random.default_rng(7)
    sd["blocks.mlp.w_up"] = (rng.standard_normal((2, 3161)) * 40.0).astype(np.float32)
    return sd


HEADERS = {"client": "site-1", "round": 3, "num_samples": 8}


def _ref_encode_items(stack=CROSS_STACK):
    p = ref_pl.build_pipeline(stack)
    with ref_ops.backend("ref"):
        msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
        return [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


def _port_encode_items(stack=CROSS_STACK):
    p = pl.build_pipeline(stack, device="cpu")
    msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
    return [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


def _check_envelopes_equal(stack):
    ref_items, port_items = _ref_encode_items(stack), _port_encode_items(stack)
    assert len(ref_items) == len(port_items) == len(_cross_sd()) + 1
    for r, p in zip(ref_items, port_items):
        assert r == p


def test_envelopes_bitwise_equal_across_packages():
    _check_envelopes_equal(CROSS_STACK)


def test_nf4_envelopes_bitwise_equal_across_packages():
    """nf4 codes, absmax, the uint8 payload's header and the zlib and
    crc32 metadata frame exactly as the reference frames them."""
    _check_envelopes_equal(NF4_CROSS_STACK)


def _bitwise_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _check_port_decodes_reference_stream(stack, decode_values):
    def ref_stream(on_chunk, decoder_pipeline):
        p = ref_pl.build_pipeline(stack)
        drv = ref_sm.LoopbackDriver()
        drv.connect(on_chunk)
        msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
        ref_sm.ContainerStreamer(drv, 4096).send_items(p.iter_encode_views(msg, ctx),
                                                       p.n_items(msg))

    with ref_ops.backend("ref"):
        ref_p = ref_pl.build_pipeline(stack, decode_values=decode_values)
        ref_dec = ref_p.decoder()
        ref_recv = ref_sm.ContainerReceiver(consume=ref_dec.on_item,
                                            decode_item=ref_dec.decode_item)
        ref_stream(ref_recv.on_chunk, ref_p)
        ref_out = ref_dec.finish(RefKind.TASK_RESULT)

        port_p = pl.build_pipeline(stack, decode_values=decode_values, device="cpu")
        port_dec = port_p.decoder()
        port_recv = sm.ContainerReceiver(consume=port_dec.on_item,
                                         decode_item=port_dec.decode_item)
        ref_stream(port_recv.on_chunk, port_p)
    port_out = port_dec.finish(MessageKind.TASK_RESULT)

    assert port_out.headers == ref_out.headers
    assert list(port_out.payload) == list(ref_out.payload)
    for name, want in ref_out.payload.items():
        got = port_out.payload[name]
        if isinstance(got, QuantizedTensor):
            assert got.fmt == want.fmt and got.orig_shape == want.orig_shape
            assert str(got.orig_dtype) == str(want.orig_dtype)
            _bitwise_equal(got.payload, want.payload)
            _bitwise_equal(got.absmax, want.absmax)
        else:
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            _bitwise_equal(got, want)


@pytest.mark.parametrize("decode_values", [True, False], ids=["dequantized", "wire_form"])
def test_port_decodes_reference_stream(decode_values):
    """Reference ContainerStreamer -> port ContainerReceiver + decoder,
    in 4 KiB chunks (multi-chunk items), item for item against the
    reference decoding its own stream."""
    _check_port_decodes_reference_stream(CROSS_STACK, decode_values)


@pytest.mark.parametrize("decode_values", [True, False], ids=["dequantized", "wire_form"])
def test_port_decodes_reference_nf4_stream(decode_values):
    """The same for nf4 + zlib + crc32: packed codes come out bitwise,
    and so do the values the port's dequantize makes of them."""
    _check_port_decodes_reference_stream(NF4_CROSS_STACK, decode_values)


def _port_sends(stack):
    def send(on_chunk):
        p = pl.build_pipeline(stack, device="cpu")
        drv = sm.LoopbackDriver()
        drv.connect(on_chunk)
        msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
        sm.ContainerStreamer(drv, 4096).send_items(p.iter_encode_views(msg, ctx), p.n_items(msg))
    return send


def _ref_sends(stack):
    def send(on_chunk):
        p = ref_pl.build_pipeline(stack)
        drv = ref_sm.LoopbackDriver()
        drv.connect(on_chunk)
        with ref_ops.backend("ref"):
            msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, _cross_sd(),
                                                 dict(HEADERS)))
            ref_sm.ContainerStreamer(drv, 4096).send_items(p.iter_encode_views(msg, ctx),
                                                           p.n_items(msg))
    return send


def _receive(p, sm_mod, kind, send):
    dec = p.decoder()
    send(sm_mod.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item).on_chunk)
    return dec.finish(kind)


def _port_decoded(stack):
    return _receive(pl.build_pipeline(stack, device="cpu"), sm, MessageKind.TASK_RESULT,
                    _port_sends(stack))


def _port_decodes_ref(stack):
    return _receive(pl.build_pipeline(stack, device="cpu"), sm, MessageKind.TASK_RESULT,
                    _ref_sends(stack))


def _ref_decoded(stack):
    with ref_ops.backend("ref"):
        return _receive(ref_pl.build_pipeline(stack), ref_sm, RefKind.TASK_RESULT,
                        _ref_sends(stack))


def _ref_decodes_port(stack):
    with ref_ops.backend("ref"):
        return _receive(ref_pl.build_pipeline(stack), ref_sm, RefKind.TASK_RESULT,
                        _port_sends(stack))


def _check_reference_decodes_port_stream(stack):
    port_out, ref_out = _port_decoded(stack), _ref_decodes_port(stack)
    assert ref_out.headers == port_out.headers
    assert list(ref_out.payload) == list(port_out.payload)
    for name, got in ref_out.payload.items():
        want = port_out.payload[name]
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        _bitwise_equal(np.asarray(got), want)


def test_reference_decodes_port_stream():
    """Port ContainerStreamer -> reference ContainerReceiver + decoder,
    against the port decoding its own stream."""
    _check_reference_decodes_port_stream(CROSS_STACK)


def test_reference_decodes_port_nf4_stream():
    _check_reference_decodes_port_stream(NF4_CROSS_STACK)


def test_header_dtype_strings_are_numpy_names():
    """Wire headers name dtypes as numpy does ("float32", "int8"), never
    "torch.float32", whether the payload held tensors or arrays."""
    views = ser.serialize_item_views("w", torch.ones((3, 5), dtype=torch.float32))
    assert b'"dtype": "float32"' in bytes(views[0])
    p = pl.build_pipeline(["quantize:blockwise8"], device="cpu")
    msg, ctx = p.begin_encode(Message(MessageKind.TASK_DATA,
                                      {"w": torch.ones((3, 5))}, {}))
    blob = b"".join(ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx))
    assert b'"payload_dtype": "int8"' in blob and b'"orig_dtype": "float32"' in blob
    assert b"torch." not in blob


def _dense(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("stage", ["lora", "topk", "zstd"])
def test_unported_stages_raise_not_implemented(stage):
    """Named for the three stage names that once raised here: each is now
    registered in both packages, and a stream the port encodes with it
    decodes in the reference to what the port decodes (lora: each side's
    own SVD, so the dense items agree within 1e-5 of their largest entry;
    topk and zstd bitwise), and the reverse."""
    assert stage in pl.registered_stages() and stage in ref_pl.registered_stages()
    assert stage not in pl.NOT_PORTED_STAGES
    stack = [stage, "crc32"]
    port_own, ref_own = _port_decoded(stack), _ref_decoded(stack)
    for got, want in ((_ref_decodes_port(stack), port_own), (_port_decodes_ref(stack), ref_own)):
        assert list(got.payload) == list(want.payload)
        for name, w in want.payload.items():
            g, w = _dense(got.payload[name]), _dense(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            if stage == "lora":
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name
            else:
                assert g.tobytes() == w.tobytes(), name


def test_unported_formats_raise_not_implemented():
    """Named for the bf16 specs that once raised here: both build, frame
    the reference's envelopes bitwise, and decode to its values."""
    for spec in ("quantize:bf16", "quantize:norm=bf16,nf4"):
        pl.build_pipeline([spec], device="cpu")
        _check_envelopes_equal([spec, "crc32"])
        _check_reference_decodes_port_stream([spec, "crc32"])


def test_fused_group_layout_is_the_per_tensor_wire_layout():
    """``pack_group`` (the buffer the one quantize launch per message and
    format runs over, and that ``chip_smoke.py`` checks on the card)
    holds each tensor at its own whole-block span, zero-padded exactly
    as the reference pads a lone tensor — for 4096-element blockwise8
    blocks and 64-element 4-bit blocks alike."""
    from repro_torch.core.quantization import pack_group

    sd = {k: v for k, v in _golden_sd().items() if v.ndim}
    sd["ragged"] = np.arange(4096 + 70, dtype=np.float32)
    for block in (4096, 64):
        big, spans = pack_group(sd, list(sd), torch.device("cpu"), block)
        assert big.shape == (sum(nb for *_, nb in spans), block)
        for name, shape, dtype, start, nb in spans:
            want, _n = ref_ops._pad_to_blocks(jax.numpy.asarray(sd[name]).reshape(-1), block)
            want = np.asarray(want)
            assert shape == sd[name].shape and dtype == np.float32
            assert big[start:start + nb].numpy().tobytes() == want.tobytes(), (name, block)


def test_per_layer_rules_with_nf4_frame_like_the_reference():
    """``quantize:norm=fp16,embed=keep,nf4``: the norm goes fp16, the
    embedding stays fp32, the rest nf4 — the same envelopes as the
    reference writes, two rounds."""
    stack = ["quantize:norm=fp16,embed=keep,nf4", "crc32"]
    port = pl.build_pipeline(stack, device="cpu")
    ref = ref_pl.build_pipeline(stack)
    for rnd in range(2):
        headers = {"client": "site-0", "round": rnd, "num_samples": 17}
        msg, ctx = port.begin_encode(Message(MessageKind.TASK_RESULT, _golden_sd(),
                                             dict(headers)))
        got = [ser.join_views(v) for _n, v in port.iter_encode_views(msg, ctx)]
        with ref_ops.backend("ref"):
            rmsg, rctx = ref.begin_encode(RefMessage(RefKind.TASK_RESULT, _golden_sd(),
                                                     dict(headers)))
            want = [ser.join_views(v) for _n, v in ref.iter_encode_views(rmsg, rctx)]
        assert got == want
    assert b'"fmt": "fp16"' in got[3] and b'"fmt": "nf4"' in got[2]


def _envelope(blob: bytes) -> tuple[dict, bytes]:
    (hlen,) = struct.unpack_from("<I", blob, 0)
    return json.loads(blob[4:4 + hlen]), blob[4 + hlen:]


def _reframe(header: dict, body: bytes) -> bytes:
    hb = json.dumps(header, sort_keys=True).encode()
    return struct.pack("<I", len(hb)) + hb + body


def test_zlib_stream_that_misses_its_declared_length_raises():
    """A zlib body that inflates to more, or less, than the envelope
    declares is rejected as a wire fault, in both packages."""
    p = pl.build_pipeline(["zlib"], device="cpu")
    msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, _golden_sd(), dict(HEADERS)))
    items = [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]
    header, body = _envelope(items[1])
    assert header["b"][0][0] == "zlib"
    for delta_n, cut in ((-1, 0), (+1, 0), (0, 7)):
        bad = json.loads(json.dumps(header))
        bad["b"][0][1]["n"] += delta_n
        tampered = body[:len(body) - cut]
        bad["n"] = len(tampered)
        blob = _reframe(bad, tampered)
        with pytest.raises(pl.WireIntegrityError, match="declared length"):
            p.decoder().decode_item(blob)
        with pytest.raises(ref_pl.WireIntegrityError, match="declared length"):
            ref_pl.build_pipeline(["zlib"]).decoder().decode_item(blob)
    name, value, _ = p.decoder().decode_item(items[1])
    _bitwise_equal(value, _golden_sd()[name])


def _delta_rounds(rounds: int = 3):
    """Round-keyed payloads: float tensors drift, one changes shape."""
    out = []
    for rnd in range(rounds):
        sd = _golden_sd()
        rng = np.random.default_rng(100 + rnd)
        for k in ("embed.w", "layers.0.attn.wq"):
            sd[k] = (sd[k] + rng.standard_normal(sd[k].shape).astype(np.float32)
                     * np.float32(0.01 * rnd)).astype(np.float32)
        if rnd == 2:
            sd["layers.0.norm"] = np.ones((32,), np.float32)   # a full snapshot again
        out.append(sd)
    return out


def _decode_all(pipeline, blobs):
    dec = pipeline.decoder()
    for blob in blobs:
        dec.on_item(*dec.decode_item(blob)[:2])
    return dec.finish(MessageKind.TASK_RESULT).payload


def _as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_delta_stack_bitwise_equal_across_packages_and_round_trips():
    """``delta`` (full snapshot, residuals, a shape change) under zlib +
    crc32: the port writes the reference's bytes round after round, and
    its decoder rebuilds what the reference's decoder rebuilds (``base +
    (x - base)``, within an ulp of ``x``)."""
    stack = ["delta", "zlib", "crc32"]
    port, ref = pl.build_pipeline(stack, device="cpu"), ref_pl.build_pipeline(stack)
    port_rx, ref_rx = pl.build_pipeline(stack, device="cpu"), ref_pl.build_pipeline(stack)
    for rnd, sd in enumerate(_delta_rounds()):
        headers = {"client": "site-2", "round": rnd, "num_samples": 5}
        msg, ctx = port.begin_encode(Message(MessageKind.TASK_RESULT, dict(sd), dict(headers)))
        got = [ser.join_views(v) for _n, v in port.iter_encode_views(msg, ctx)]
        with ref_ops.backend("ref"):
            rmsg, rctx = ref.begin_encode(RefMessage(RefKind.TASK_RESULT, dict(sd),
                                                     dict(headers)))
            want = [ser.join_views(v) for _n, v in ref.iter_encode_views(rmsg, rctx)]
            ref_out = _decode_all(ref_rx, want)
        assert got == want, rnd
        port_out = _decode_all(port_rx, got)
        for name, value in sd.items():
            rebuilt = _as_np(port_out[name])
            _bitwise_equal(rebuilt, np.asarray(ref_out[name]))
            if rebuilt.dtype == np.float32:
                np.testing.assert_allclose(rebuilt, value, rtol=1e-6, atol=1e-6)


def test_delta_snapshots_share_no_memory_with_decoded_tensors():
    """The port updates decoded parameters in place; doing so must not
    change what a delta stage encodes or decodes next round — with split
    ends, and with one instance serving both (the in-process wire, where
    the decoder adopts the encoder's snapshot). The decoders take each
    item as the sender's unjoined segments, as a zero-copy hop hands it
    over, so a decoded full snapshot could alias the sender's memory."""
    setups = {"clean": [pl.build_pipeline(["delta"], device="cpu") for _ in range(2)],
              "split": [pl.build_pipeline(["delta"], device="cpu") for _ in range(2)]}
    shared = pl.build_pipeline(["delta"], device="cpu")
    setups["shared"] = [shared, shared]
    outs = {key: [] for key in setups}
    for rnd, sd in enumerate(_delta_rounds(2)):
        for key, (tx, rx) in setups.items():
            msg, ctx = tx.begin_encode(Message(MessageKind.TASK_DATA, dict(sd),
                                               {"client": "site-0", "round": rnd}))
            items = [views for _n, views in tx.iter_encode_views(msg, ctx)]
            blobs = [ser.join_views(v) for v in items]
            dec = rx.decoder()
            for views, blob in zip(items, blobs):
                dec.on_item(*dec.decode_item(blob if key == "clean" else list(views))[:2])
            payload = dec.finish(MessageKind.TASK_DATA).payload
            outs[key].append((blobs, {k: _as_np(v).copy() for k, v in payload.items()}))
            if key != "clean":
                for name in ("embed.w", "layers.0.attn.wq"):
                    payload[name].add_(1000.0)    # what local training does to it
    for key in ("split", "shared"):
        for (blobs, values), (want_blobs, want_values) in zip(outs[key], outs["clean"]):
            assert blobs == want_blobs, key
            for name, want in want_values.items():
                _bitwise_equal(values[name], want)


def test_desynchronised_delta_stream_raises():
    """A receiver that missed a round (or restarted) sees a residual whose
    stream position is not its own, and raises instead of rebuilding."""
    stack = ["delta", "crc32"]
    tx = pl.build_pipeline(stack, device="cpu")
    blobs = []
    for rnd, sd in enumerate(_delta_rounds(2)):
        msg, ctx = tx.begin_encode(Message(MessageKind.TASK_RESULT, dict(sd),
                                           {"client": "site-0", "round": rnd}))
        blobs.append([ser.join_views(v) for _n, v in tx.iter_encode_views(msg, ctx)])
    rx = pl.build_pipeline(stack, device="cpu").decoder()
    rx.on_item(*rx.decode_item(blobs[1][0])[:2])          # meta item of round 2
    with pytest.raises(pl.WireIntegrityError, match="out of sync"):
        rx.decode_item(blobs[1][1])
    # a decoder that saw round 1 takes round 2
    rx = pl.build_pipeline(stack, device="cpu")
    for items in blobs:
        dec = rx.decoder()
        for blob in items:
            dec.on_item(*dec.decode_item(blob)[:2])
    # and a corrupted residual is caught by the crc below it
    header, body = _envelope(blobs[1][1])
    flipped = bytearray(body)
    flipped[-1] ^= 0x01
    with pytest.raises(pl.WireIntegrityError, match="crc32"):
        pl.build_pipeline(stack, device="cpu").decoder().decode_item(
            _reframe(header, bytes(flipped)))
    assert zlib.crc32(body) == header["b"][0][1]["crc"]
