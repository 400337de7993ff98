"""Card-only checks of the streaming receiver's page-locked buffers
(marker ``cuda``).

A container receiver beside a decoder that lands its tensors on the card
assembles every multi-chunk item in a page-locked block from torch's
caching host allocator: each ``wire.reassemble`` span says ``pinned``,
a second identical transfer creates no block and spends under 1 % of the
first one's allocation time, the decoded tensors are bitwise those of
the same transfer decoded on the CPU, a decoded view that outlives its
item keeps its bytes, and the profiler sees the decode's host-to-device
copies as ``Pinned -> Device``. Imports torch and the port only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_receive_buffer_cuda.py

Elsewhere the tests skip.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import streaming as sm  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

STACK = ["quantize:blockwise8", "crc32"]
CHUNK = 1 << 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SMALL = {"embed": (6144, 4096), "mlp": (4096, 1536), "attn": (1280, 4096)}
# items of the benchmark's order of size (stablelm's are 100-277 MB of codes)
LARGE = {"embed": (8192, 8192), "mlp": (8192, 6144), "attn": (4096, 8192)}


def _sd(seed, device, shapes=SMALL):
    """Items of blockwise8 codes of several 1 MiB chunks each: 5-24 MB
    (``SMALL``) or 32-64 MB (``LARGE``)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return {name: torch.randn(shape, generator=g).to(device) for name, shape in shapes.items()}


def _transfer(sd, device, decode_values=True):
    """One transfer of ``sd`` through a loopback container stream, decoded
    onto ``device``; returns (payload, the ``wire.reassemble`` span args)."""
    pipe = pl.build_pipeline(STACK, device=device, decode_values=decode_values)
    msg, ctx = pipe.begin_encode(Message(MessageKind.TASK_RESULT, dict(sd), {"num_samples": 2}))
    dec = pipe.decoder()
    recv = sm.ContainerReceiver(consume=dec.on_item, decode_item=dec.decode_item,
                                device=dec.ctx.device)
    driver = sm.LoopbackDriver()
    driver.connect(recv.on_chunk)
    tracer = Tracer()
    with obs_trace.activate(tracer):
        sm.ContainerStreamer(driver, CHUNK).send_items(pipe.iter_encode_views(msg, ctx),
                                                       pipe.n_items(msg))
    payload = dec.finish(MessageKind.TASK_RESULT).payload
    spans = [ev["args"] for ev in tracer.chrome_trace()["traceEvents"]
             if ev.get("name") == "wire.reassemble"]
    return payload, spans


def _blocks():
    """Page-locked blocks the caching host allocator has created so far."""
    stats = torch.cuda.host_memory_stats()
    for key in ("num_host_alloc", "allocations.allocated", "segment.allocated"):
        if key in stats:
            return stats[key]
    raise KeyError(f"no block count among {sorted(stats)}")


@pytest.mark.cuda
def test_cuda_decoder_pins_and_reuses_its_blocks(cuda):
    torch.cuda.synchronize()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()   # the first transfer then creates its blocks
    sd = _sd(0, cuda, LARGE)
    before = _blocks()
    _, first = _transfer(sd, cuda)
    created = _blocks() - before
    torch.cuda.synchronize()   # the sender's staging blocks back in the cache too
    _, second = _transfer(sd, cuda)
    assert len(first) == len(second) == 3
    assert all(sp["pinned"] is True for sp in first + second)
    assert _blocks() - before == created
    alloc = [sum(sp["alloc_s"] for sp in spans) for spans in (first, second)]
    assert alloc[1] < 0.01 * alloc[0], alloc


@pytest.mark.cuda
def test_card_decode_is_bitwise_the_cpu_decode(cuda):
    sd = _sd(1, cuda)
    card, spans = _transfer(sd, cuda)
    host, host_spans = _transfer({k: v.cpu() for k, v in sd.items()}, "cpu")
    assert all(sp["pinned"] for sp in spans) and not any(sp["pinned"] for sp in host_spans)
    assert list(card) == list(host)
    for name in sd:
        assert card[name].device.type == "cuda"
        assert torch.equal(card[name].cpu().view(torch.int32), host[name].view(torch.int32))


@pytest.mark.cuda
def test_decoded_view_outlives_its_pinned_block(cuda):
    first, _ = _transfer(_sd(2, cuda), cuda, decode_values=False)
    kept = {n: (np.asarray(v.payload).tobytes(), np.asarray(v.absmax).tobytes())
            for n, v in first.items()}
    _transfer(_sd(3, cuda), cuda, decode_values=False)
    _transfer(_sd(3, cuda), cuda)
    for name, value in first.items():
        assert np.asarray(value.payload).tobytes() == kept[name][0], name
        assert np.asarray(value.absmax).tobytes() == kept[name][1], name


@pytest.mark.cuda
def test_decode_copies_to_the_card_from_pinned_memory(cuda):
    from torch.profiler import ProfilerActivity, profile

    sd = _sd(4, cuda)
    _transfer(sd, cuda)   # blocks created outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _transfer(sd, cuda)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.name.startswith("Memcpy HtoD")]
    assert names, "no host-to-device copy seen"
    assert all("Pinned" in n for n in names), sorted(set(names))
