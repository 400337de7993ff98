"""Port parity, the last wire stages: ``topk``, ``zstd`` and the ``bf16``
format, each on the wire against the reference, and the two packages'
stage registries.

* ``topk``: envelopes and container streams bitwise, with ties, ±0,
  ±inf and NaNs of either sign and any payload in the payload (the
  port's selection is a stable ``torch.sort`` on the tensor's device,
  the reference's a stable numpy ``argsort``).
* ``zstd``: envelopes bitwise, cross-decoded both ways; a stream longer
  or shorter than its declared length raises; registered only when
  ``zstandard`` imports, in both packages.
* ``bf16``: every one of the 65,536 bf16 patterns decodes to the
  reference's fp32 bits, whether its payload is a jax array (the sender
  side) or numpy (decoded from the wire); an fp32 sweep of normals,
  subnormals, ±inf, NaN payloads of both signs and rounding ties
  encodes to the reference's bits (torch's own CPU cast does not: it
  gives ``0xffff`` for a NaN).
* ``lora:8 -> quantize:nf4 -> zstd:3 -> crc32`` cross-decoded both ways.
"""
import json
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import quantization as ref_q  # noqa: E402
from repro.core import streaming as ref_sm  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.peft.lowrank import LowRankDelta as RefLowRankDelta  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import quantization as q  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core import sparse  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.peft.lowrank import LowRankDelta  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HEADERS = {"client": "site-2", "round": 1, "num_samples": 6}


def _f32(words):
    return np.asarray(words, np.uint32).view(np.float32)


def _special_sd():
    """Float items full of ties (repeated magnitudes, ±x pairs), ±0,
    ±inf and NaNs of both signs and several payloads, beside a plain
    Gaussian item, a small one and an int one."""
    rng = np.random.default_rng(11)
    ties = np.repeat(np.arange(1, 65, dtype=np.float32) / 8, 40)
    ties[::3] *= -1
    ties[::7] = 0.0
    ties[5::11] = -0.0
    rng.shuffle(ties)
    odd = rng.standard_normal(3000).astype(np.float32)
    odd[[7, 70, 700]] = _f32([0x7FC00000, 0xFFC12345, 0x7F800001])   # NaNs
    odd[[8, 80]] = [np.inf, -np.inf]
    odd[[9, 90, 900, 901]] = [0.0, -0.0, 1e-40, -1e-40]
    return {
        "ties": ties.reshape(40, 64),
        "odd": odd.reshape(3, 1000),
        "gauss": rng.standard_normal((64, 48)).astype(np.float32),
        "small": rng.standard_normal(100).astype(np.float32),
        "ints": np.arange(512, dtype=np.int32),
    }


def _ref_items(stack, sd):
    p = ref_pl.build_pipeline(stack)
    with ref_ops.backend("ref"):
        msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, dict(sd), dict(HEADERS)))
        return [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


def _port_items(stack, sd, tensors=True):
    p = pl.build_pipeline(stack, device="cpu")
    payload = {k: torch.from_numpy(v.copy()) for k, v in sd.items()} if tensors else dict(sd)
    msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, payload, dict(HEADERS)))
    return [ser.join_views(v) for _n, v in p.iter_encode_views(msg, ctx)]


@pytest.fixture
def zstd():
    """The tests of the zstd stage need the package it registers with."""
    return pytest.importorskip("zstandard")


def _chunks(sm_mod, p, msg, ctx, chunk=256):
    out = []
    drv = sm_mod.LoopbackDriver()
    drv.connect(lambda c: out.append((c.seq, c.flags, b"".join(bytes(s) for s in c.segments))))
    sm_mod.ContainerStreamer(drv, chunk).send_items(p.iter_encode_views(msg, ctx),
                                                    p.n_items(msg))
    return out


def _decode(sm_mod, decoder_pipeline, sender, kind):
    dec = decoder_pipeline.decoder()
    recv = sm_mod.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item)
    sender(recv.on_chunk)
    return dec.finish(kind)


def _ref_sender(stack, sd):
    def send(on_chunk):
        p = ref_pl.build_pipeline(stack)
        drv = ref_sm.LoopbackDriver()
        drv.connect(on_chunk)
        with ref_ops.backend("ref"):
            msg, ctx = p.begin_encode(RefMessage(RefKind.TASK_RESULT, dict(sd), dict(HEADERS)))
            ref_sm.ContainerStreamer(drv, 1024).send_items(p.iter_encode_views(msg, ctx),
                                                           p.n_items(msg))
    return send


def _port_sender(stack, sd):
    def send(on_chunk):
        p = pl.build_pipeline(stack, device="cpu")
        drv = sm.LoopbackDriver()
        drv.connect(on_chunk)
        msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT,
                                          {k: torch.from_numpy(v.copy()) for k, v in sd.items()},
                                          dict(HEADERS)))
        sm.ContainerStreamer(drv, 1024).send_items(p.iter_encode_views(msg, ctx), p.n_items(msg))
    return send


def _bits(x):
    """The raw bytes of an array, a tensor (bf16 included) or a wire container."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _cross_decode(stack, sd, decode_values=True):
    """Each package decodes the other's container stream to what it
    makes of its own, item for item and bit for bit."""
    with ref_ops.backend("ref"):
        ref_own = _decode(ref_sm, ref_pl.build_pipeline(stack, decode_values=decode_values),
                          _ref_sender(stack, sd), RefKind.TASK_RESULT)
        ref_of_port = _decode(ref_sm, ref_pl.build_pipeline(stack, decode_values=decode_values),
                              _port_sender(stack, sd), RefKind.TASK_RESULT)
    port_own = _decode(sm, pl.build_pipeline(stack, decode_values=decode_values, device="cpu"),
                       _port_sender(stack, sd), MessageKind.TASK_RESULT)
    port_of_ref = _decode(sm, pl.build_pipeline(stack, decode_values=decode_values, device="cpu"),
                          _ref_sender(stack, sd), MessageKind.TASK_RESULT)
    for got, want in ((ref_of_port, port_own), (port_of_ref, ref_own)):
        assert got.headers == want.headers
        assert list(got.payload) == list(want.payload)
        for name, w in want.payload.items():
            g = got.payload[name]
            fields = WIRE_FIELDS.get(type(w).__name__)
            assert type(g).__name__ == type(w).__name__ or fields is None, name
            for f in fields or ():
                if getattr(w, f) is not None:
                    assert _bits(getattr(g, f)) == _bits(getattr(w, f)), (name, f)
            if fields is None:
                assert _bits(g) == _bits(w), name
    return ref_own, port_own


#: the buffers of each wire container, by class name (the same in both packages)
WIRE_FIELDS = {"QuantizedTensor": ("payload", "absmax"), "SparseTensor": ("indices", "values"),
               "LowRankDelta": ("a", "b")}


def _package_stages(mod) -> tuple:
    """The stages a package registers itself: other test files of this
    worker may have added test stages to the reference's registry
    (``tests/test_pipeline.py``, ``tests/test_wire_golden.py``)."""
    return tuple(name for name in mod.registered_stages()
                 if mod._STAGES[name].__module__.split(".")[0] in ("repro", "repro_torch"))


def test_registered_stages_equal_the_references():
    assert _package_stages(pl) == _package_stages(ref_pl)
    assert pl.NOT_PORTED_STAGES == ()
    assert q.PORTED_FORMATS == q.FORMATS == ref_q.FORMATS


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [0.01, 0.1, 0.5, 1.0])
def test_topk_envelopes_bitwise(fraction):
    stack = [f"topk:{fraction}", "crc32"]
    want = _ref_items(stack, _special_sd())
    assert _port_items(stack, _special_sd()) == want
    assert _port_items(stack, _special_sd(), tensors=False) == want


def test_topk_container_streams_bitwise():
    stack = ["topk:0.05", "crc32"]
    sd = _special_sd()
    rp = ref_pl.build_pipeline(stack)
    rmsg, rctx = rp.begin_encode(RefMessage(RefKind.TASK_RESULT, dict(sd), dict(HEADERS)))
    pp = pl.build_pipeline(stack, device="cpu")
    pmsg, pctx = pp.begin_encode(Message(MessageKind.TASK_RESULT,
                                         {k: torch.from_numpy(v) for k, v in sd.items()},
                                         dict(HEADERS)))
    want = _chunks(ref_sm, rp, rmsg, rctx)
    assert len(want) > 10 and _chunks(sm, pp, pmsg, pctx) == want


def test_topk_selection_equals_numpy_on_nan_ties_and_zeros():
    """The device path keeps the reference's entries and order: ties to
    the lower index, NaN last whatever its sign and payload, -0 == +0."""
    x = _f32([0xFFC00001, 0x3F800000, 0xBF800000, 0x80000000, 0x00000000, 0x7FC00000,
              0x7F800000, 0xFF800000, 0x3F800000, 0x00000001, 0x80000001, 0x7FA00000])
    for k in range(1, x.size + 1):
        want = sparse.topk_sparsify(x, k / x.size)
        got = sparse.topk_sparsify(torch.from_numpy(x), k / x.size)
        assert got.indices.dtype == want.indices.dtype == np.int32
        assert got.indices.tobytes() == want.indices.tobytes(), k
        assert got.values.tobytes() == want.values.tobytes(), k


def test_topk_cross_decodes_both_ways():
    for decode_values in (True, False):
        _cross_decode(["topk:0.1", "crc32"], _special_sd(), decode_values)


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stack", [["zstd"], ["zstd:9", "crc32"], ["quantize:nf4", "zstd:3"]],
                         ids=["zstd", "zstd9-crc32", "nf4-zstd3"])
def test_zstd_envelopes_bitwise_and_cross_decoded(stack, zstd):
    sd = {k: v for k, v in _special_sd().items() if k != "odd"}   # nf4 of NaN blocks is moot
    assert _port_items(stack, sd) == _ref_items(stack, sd)
    _cross_decode(stack, sd)


def _zstd_envelope(n_declared):
    p = pl.build_pipeline(["zstd"], device="cpu")
    msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT,
                                      {"w": torch.arange(4096, dtype=torch.float32)}, {}))
    blob = ser.join_views(list(p.iter_encode_views(msg, ctx))[1][1])
    (hlen,) = struct.unpack_from("<I", blob)
    header = json.loads(blob[4:4 + hlen])
    assert header["b"][0][0] == "zstd"
    header["b"][0][1]["n"] += n_declared
    hb = json.dumps(header, sort_keys=True).encode()
    return p, struct.pack("<I", len(hb)) + hb + blob[4 + hlen:]


@pytest.mark.parametrize("delta", [-1, -100, 1, 100],
                         ids=["over1", "over100", "under1", "under100"])
def test_zstd_stream_that_misses_its_declared_length_raises(delta, zstd):
    """``delta`` < 0: the stream holds more than it declares (oversize);
    > 0: less (undersize). Both are wire-integrity faults, in both
    packages."""
    p, blob = _zstd_envelope(delta)
    ctx = pl.WireContext({}, device="cpu")
    with pytest.raises(pl.WireIntegrityError, match="zstd stream"):
        p.decode_wire_item(blob, ctx)
    with pytest.raises(ref_pl.WireIntegrityError, match="zstd stream"):
        ref_pl.build_pipeline(["zstd"]).decode_wire_item(blob, ref_pl.WireContext({}))


def test_zstd_keeps_one_context_pair_per_thread(zstd):
    stage = pl.build_stage("zstd:5")
    first = stage._ctxs()
    assert stage._ctxs() is not first and stage._ctxs() == first   # same objects, new tuple
    other = []
    t = threading.Thread(target=lambda: other.append(stage._ctxs()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and other[0][0] is not first[0] and other[0][1] is not first[1]


def test_zstd_registers_only_when_zstandard_imports(zstd):
    code = (
        "import sys; sys.modules['zstandard'] = None\n"
        "from repro_torch.core import pipeline as pl\n"
        "from repro.core import pipeline as ref_pl\n"
        "assert 'zstd' not in pl.registered_stages(), pl.registered_stages()\n"
        "assert pl.registered_stages() == ref_pl.registered_stages()\n"
        "try:\n"
        "    pl.build_pipeline(['zstd'], device='cpu')\n"
        "except ValueError as e:\n"
        "    assert 'unknown stage' in str(e)\n"
        "else:\n"
        "    raise SystemExit('zstd built without zstandard')\n"
    )
    env = {"PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "zstd" in pl.registered_stages()


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

ALL_BF16 = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)


def _sweep():
    """fp32 words: normals, subnormals, ±0, ±inf, NaN payloads of both
    signs (quiet and signalling), exact rounding ties (low half 0x8000)
    with both parities, neighbours of the ties, the largest finite and
    values that round up into inf."""
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 16, 20000, dtype=np.uint32) << 16
    words = [hi | rng.integers(0, 1 << 16, 20000, dtype=np.uint32),   # anything
             hi | 0x8000, hi | 0x7FFF, hi | 0x8001,                    # ties and neighbours
             rng.integers(1, 1 << 23, 2000, dtype=np.uint32),          # + subnormals
             rng.integers(1, 1 << 23, 2000, dtype=np.uint32) | 0x80000000,
             np.asarray([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF,
                         0x7F7F8000, 0x7F7F7FFF, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001,
                         0xFF800001, 0x7FC00000, 0xFFC12345, 0x7FA00000, 0x007F8000,
                         0x00008000, 0x00018000], np.uint32)]
    return np.concatenate(words)


def test_bf16_encode_of_an_fp32_sweep_is_the_references():
    x = _f32(_sweep())
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = q.narrow_bf16(torch.from_numpy(x)).view(torch.int16).numpy().view(np.uint16)
    assert got.tobytes() == want.tobytes()
    qt, ref_qt = q.quantize(torch.from_numpy(x), "bf16"), ref_q.quantize(jnp.asarray(x), "bf16")
    assert qt.payload.dtype == torch.bfloat16 and qt.orig_shape == ref_qt.orig_shape
    assert _bits(qt.payload) == np.asarray(ref_qt.payload).tobytes()
    # subnormals kept, not flushed; every NaN is sign | 0x7fc0
    nan = np.isnan(x)
    assert set(got[nan].tolist()) == {0x7FC0, 0xFFC0}
    assert (got[nan] >> 15 == _sweep()[nan] >> 31).all()
    tiny = (np.abs(x) > 0) & (np.abs(x) < np.float32(2.0 ** -126))
    assert (got[tiny] & 0x7FFF).any()


@pytest.mark.parametrize("source", ["jax", "numpy"])
def test_bf16_decode_of_all_65536_patterns_is_the_references(source):
    """The reference decodes a bf16 payload with ``astype``: of a jax
    array on the sending side, of numpy (ml_dtypes) off the wire. Both
    are ``bits << 16``; so is the port's decode."""
    words = ALL_BF16.view(np.int16)
    if source == "jax":
        payload = jnp.asarray(words).view(jnp.bfloat16)
    else:
        payload = words.view(np.dtype("bfloat16"))
    want = np.asarray(ref_q.dequantize(ref_q.QuantizedTensor(
        payload, None, "bf16", (1 << 16,), np.dtype(np.float32))))
    got = q.dequantize(q.QuantizedTensor(torch.from_numpy(words.copy()).view(torch.bfloat16),
                                         None, "bf16", (1 << 16,), np.dtype(np.float32)), "cpu")
    assert got.dtype == torch.float32
    assert got.numpy().view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert (got.numpy().view(np.uint32) == ALL_BF16.astype(np.uint32) << 16).all()


@pytest.mark.parametrize("stack", [["quantize:bf16", "crc32"], ["quantize:norm=bf16,nf4"]],
                         ids=["bf16-crc32", "norm-bf16-nf4"])
def test_bf16_envelopes_bitwise_and_cross_decoded(stack):
    sd = {"layers.0.norm": _f32(_sweep()[:6000]).reshape(60, 100).copy(),
          "gauss": _special_sd()["gauss"], "ints": _special_sd()["ints"]}
    assert _port_items(stack, sd) == _ref_items(stack, sd)
    for decode_values in (True, False):
        _cross_decode(stack, sd, decode_values)


def test_bf16_array_items_cross_the_wire():
    """A bf16 tensor sent as a plain array item: header dtype
    "bfloat16", the reference reads it back bitwise, and so does the port."""
    t = torch.from_numpy(ALL_BF16.view(np.int16).copy()).view(torch.bfloat16).reshape(256, 256)
    blob = ser.serialize_item("h", t)
    assert b'"dtype": "bfloat16"' in blob and ser.declared_item_nbytes(blob) == len(blob)
    name, ref_value, _ = ref_pl.ser.deserialize_item(blob)
    assert np.asarray(ref_value).view(np.uint16).tobytes() == ALL_BF16.tobytes()
    assert ref_pl.ser.serialize_item("h", ref_value) == blob
    for buf in (memoryview(blob), [blob[:100], blob[100:70000], blob[70000:]]):
        _, got, used = ser.deserialize_item(buf)
        assert used == len(blob) and got.dtype == torch.bfloat16 and _bits(got) == _bits(t)


# ---------------------------------------------------------------------------
# the combined stack
# ---------------------------------------------------------------------------

def _lora_sd():
    rng = np.random.default_rng(21)
    return {"embed.w": rng.standard_normal((96, 64)).astype(np.float32),
            "blocks.attn.wq": rng.standard_normal((2, 64, 64)).astype(np.float32),
            "blocks.norm": rng.standard_normal((2, 64)).astype(np.float32),
            "final_norm": rng.standard_normal(64).astype(np.float32)}


def test_lora_nf4_zstd_crc32_stack_cross_decodes(zstd):
    """In wire form (what ``lora-fedavg`` folds) each package reads the
    other's factors and nf4 codes bitwise; decoded, the nf4 items are
    bitwise and the merged matrices are each sender's factors merged."""
    stack = ["lora:8", "quantize:nf4", "zstd:3", "crc32"]
    ref_wire, port_wire = _cross_decode(stack, _lora_sd(), decode_values=False)
    for name in ("embed.w", "blocks.attn.wq"):
        assert isinstance(ref_wire.payload[name], RefLowRankDelta)
        assert isinstance(port_wire.payload[name], LowRankDelta)
    for name in ("blocks.norm", "final_norm"):
        assert port_wire.payload[name].fmt == "nf4"
    port_of_ref = _decode(sm, pl.build_pipeline(stack, device="cpu"),
                          _ref_sender(stack, _lora_sd()), MessageKind.TASK_RESULT)
    for name in ("embed.w", "blocks.attn.wq"):
        d = ref_wire.payload[name]
        want = np.asarray(d.a, np.float64) @ np.asarray(d.b, np.float64)
        got = port_of_ref.payload[name].double().numpy().reshape(want.shape)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
