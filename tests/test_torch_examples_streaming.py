"""``examples/torch/streaming_demo.py`` against the reference's
``examples/streaming_demo.py`` on the CPU: the same seeded 67 MB dict
gives the same MemoryMeter peaks in regular, container and file
transmission, the same nf4 checkpoint bytes and the same largest
dequantization error (the port's 4-bit codes are bitwise the
reference's); the retriever and the TCP driver (127.0.0.1) deliver every
item. The printed lines are equal once each run's wall seconds are
blanked; those are the only numbers that may differ.
"""
import re

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_examples import SECONDS, captured, load  # noqa: E402

PEAK = re.compile(r"^(\w+)\s+peak transmission memory\s+([\d.]+) MB", re.MULTILINE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_peaks_checkpoint_bytes_and_error_are_the_references():
    ref, port = load("streaming_demo", port=False), load("streaming_demo", port=True)
    _, want = captured(ref.main)
    out, got = captured(port.run, "cpu")
    assert SECONDS.sub("_", got) == SECONDS.sub("_", want)
    assert {m: f"{p / 1e6:.2f}" for m, p in out["peaks"].items()} == dict(PEAK.findall(want))
    assert out["peaks"]["regular"] > out["peaks"]["container"] > out["peaks"]["file"]
    assert f"{out['nbytes'] / 1e6:.1f} MB on disk (nf4), max dequant err {out['err']:.3f}" in want
