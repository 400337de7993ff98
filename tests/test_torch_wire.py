"""Port parity, wire level: the port's pipeline writes the reference's
bytes, and container streams cross-decode between the two packages.

The golden hashes and the ``_golden_sd`` / ``_stream_hash`` recipe are
copied from ``tests/test_wire_golden.py`` (sha256 over every envelope
of two rounds, length-prefixed), so the port is held to the same pinned
bytes as the reference.
"""
import hashlib

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
    "blockwise8": "8f89d45f32e4db30467d7a05ffb189e862b9a8f062fa010f0596cdaa2c2b1379",
    "plain": "7c00654d6d6d40ca6aa6d5733aec3923028d62eba7d8428fc58bb56da5342869",
}

STACKS = {
    "blockwise8": ["quantize:blockwise8"],
    "plain": [],
}

CROSS_STACK = ["quantize:blockwise8", "crc32"]


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


def _ref_encode_items():
    p = ref_pl.build_pipeline(CROSS_STACK)
    with ref_ops.backend("ref"):
        msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
        return [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


def _port_encode_items():
    p = pl.build_pipeline(CROSS_STACK, device="cpu")
    msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
    return [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


def test_envelopes_bitwise_equal_across_packages():
    ref_items, port_items = _ref_encode_items(), _port_encode_items()
    assert len(ref_items) == len(port_items) == len(_cross_sd()) + 1
    for r, p in zip(ref_items, port_items):
        assert r == p


def _bitwise_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("decode_values", [True, False], ids=["dequantized", "wire_form"])
def test_port_decodes_reference_stream(decode_values):
    """Reference ContainerStreamer -> port ContainerReceiver + decoder,
    in 4 KiB chunks (multi-chunk items), item for item against the
    reference decoding its own stream."""
    def ref_stream(on_chunk, decoder_pipeline):
        p = ref_pl.build_pipeline(CROSS_STACK)
        drv = ref_sm.LoopbackDriver()
        drv.connect(on_chunk)
        msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
        ref_sm.ContainerStreamer(drv, 4096).send_items(p.iter_encode_views(msg, ctx),
                                                       p.n_items(msg))

    with ref_ops.backend("ref"):
        ref_p = ref_pl.build_pipeline(CROSS_STACK, decode_values=decode_values)
        ref_dec = ref_p.decoder()
        ref_recv = ref_sm.ContainerReceiver(consume=ref_dec.on_item,
                                            decode_item=ref_dec.decode_item)
        ref_stream(ref_recv.on_chunk, ref_p)
        ref_out = ref_dec.finish(RefKind.TASK_RESULT)

        port_p = pl.build_pipeline(CROSS_STACK, decode_values=decode_values, device="cpu")
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


def test_reference_decodes_port_stream():
    """Port ContainerStreamer -> reference ContainerReceiver + decoder,
    against the port decoding its own stream."""
    def port_stream(on_chunk):
        p = pl.build_pipeline(CROSS_STACK, device="cpu")
        drv = sm.LoopbackDriver()
        drv.connect(on_chunk)
        msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, _cross_sd(), dict(HEADERS)))
        sm.ContainerStreamer(drv, 4096).send_items(p.iter_encode_views(msg, ctx),
                                                   p.n_items(msg))

    port_p = pl.build_pipeline(CROSS_STACK, device="cpu")
    port_dec = port_p.decoder()
    port_recv = sm.ContainerReceiver(consume=port_dec.on_item, decode_item=port_dec.decode_item)
    port_stream(port_recv.on_chunk)
    port_out = port_dec.finish(MessageKind.TASK_RESULT)

    with ref_ops.backend("ref"):
        ref_p = ref_pl.build_pipeline(CROSS_STACK)
        ref_dec = ref_p.decoder()
        ref_recv = ref_sm.ContainerReceiver(consume=ref_dec.on_item,
                                            decode_item=ref_dec.decode_item)
        port_stream(ref_recv.on_chunk)
        ref_out = ref_dec.finish(RefKind.TASK_RESULT)

    assert ref_out.headers == port_out.headers
    assert list(ref_out.payload) == list(port_out.payload)
    for name, got in ref_out.payload.items():
        want = port_out.payload[name]
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        _bitwise_equal(np.asarray(got), want)


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


@pytest.mark.parametrize("stage", pl.NOT_PORTED_STAGES)
def test_unported_stages_raise_not_implemented(stage):
    with pytest.raises(NotImplementedError, match="not ported"):
        pl.build_pipeline([stage], device="cpu")


def test_unported_formats_raise_not_implemented():
    for spec in ("quantize:nf4", "quantize:fp4", "quantize:bf16"):
        with pytest.raises(NotImplementedError, match="not ported"):
            pl.build_pipeline([spec], device="cpu")


def test_fused_group_layout_is_the_per_tensor_wire_layout():
    """``pack_blockwise8_group`` (the buffer the one quantize launch per
    message runs over, and that ``chip_smoke.py`` checks on the card)
    holds each tensor at its own whole-block span, zero-padded exactly
    as the reference pads a lone tensor."""
    from repro_torch.core.quantization import pack_blockwise8_group

    sd = {k: v for k, v in _golden_sd().items() if v.ndim}
    big, spans = pack_blockwise8_group(sd, list(sd), torch.device("cpu"))
    assert big.shape == (sum(nb for *_, nb in spans), 4096)
    for name, shape, dtype, start, nb in spans:
        want, _n = ref_ops._pad_to_blocks(jax.numpy.asarray(sd[name]).reshape(-1), 4096)
        want = np.asarray(want)
        assert shape == sd[name].shape and dtype == np.float32
        assert big[start:start + nb].numpy().tobytes() == want.tobytes(), name
