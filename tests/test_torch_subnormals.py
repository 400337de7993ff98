"""Port parity outside the kernels: float32 subnormals in the ``fedavg``
sums and the ``delta`` residuals.

The reference flushes subnormals wherever XLA computes (its kernels and
jitted ops: the CPU build runs with FTZ/DAZ), and the port's plain
versions and kernels flush them there too (``tests/test_torch_kernels.py``).
Its ``fedavg`` aggregator and ``delta`` stage, though, compute in numpy,
which keeps subnormals — so the port, whose tensors keep them as well,
must give the same bits without a flush. These tests send updates whose
values, products, sums and residuals are subnormal through both packages
and compare weights and wire bytes bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core.messages import Message as RefMessage  # noqa: E402
from repro.core.messages import MessageKind as RefKind  # noqa: E402
from repro.fl.aggregator import FedAvgAggregator as RefFedAvg  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import serialization as ser  # noqa: E402
from repro_torch.core.messages import Message, MessageKind  # noqa: E402
from repro_torch.fl.aggregator import FedAvgAggregator  # noqa: E402
from repro_torch.kernels.ref import FLT_MIN  # noqa: E402


def _update(seed: int) -> dict[str, np.ndarray]:
    """An update with subnormal elements, elements whose weighted products
    and sums fall below FLT_MIN, and ordinary ones."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    w[::3] *= np.float32(1e-39)          # subnormal already
    w[1::3] *= np.float32(3e-38)         # normal, but small enough to go subnormal
    return {"layer.w": w, "layer.b": (rng.standard_normal(32) * 1e-40).astype(np.float32)}


def _bitwise(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(want).view(np.int32))


def test_fedavg_keeps_subnormals_as_the_reference_does():
    updates = [(_update(s), n) for s, n in ((1, 3.0), (2, 0.37), (3, 5.0))]
    port, ref = FedAvgAggregator(device="cpu"), RefFedAvg()
    for agg in (port, ref):
        for sd, n in updates:
            for name, arr in sd.items():
                agg.accept_item(name, arr.copy(), n)
            agg.begin({"num_samples": n})
    got, want = port.finish(), ref.finish()
    assert set(got) == set(want)
    for name in want:
        _bitwise(got[name], want[name])
    sub = np.abs(want["layer.w"])
    assert ((sub > 0) & (sub < FLT_MIN)).any(), "no subnormal reached the result"


def test_delta_residuals_keep_subnormals_as_the_reference_does():
    """Round 0 ships full snapshots; rounds 1 and 2 ship residuals, many
    of them subnormal. Wire bytes and reconstructions are bitwise equal."""
    stack = ["delta", "crc32"]
    port, ref = pl.build_pipeline(stack, device="cpu"), ref_pl.build_pipeline(stack)
    port_rx, ref_rx = pl.build_pipeline(stack, device="cpu"), ref_pl.build_pipeline(stack)
    rng = np.random.default_rng(7)
    sd = _update(0)
    subnormal_residuals = 0
    for rnd in range(3):
        if rnd:
            prev = sd
            sd = {k: (v + (rng.standard_normal(v.shape) * 1e-39).astype(np.float32))
                  for k, v in sd.items()}
            residual = np.abs(np.concatenate([(sd[k] - prev[k]).ravel() for k in sd]))
            subnormal_residuals += int(((residual > 0) & (residual < FLT_MIN)).sum())
        headers = {"client": "site-1", "round": rnd, "num_samples": 4}
        msg, ctx = port.begin_encode(Message(MessageKind.TASK_RESULT, dict(sd), dict(headers)))
        got = [ser.join_views(v) for _n, v in port.iter_encode_views(msg, ctx)]
        rmsg, rctx = ref.begin_encode(RefMessage(RefKind.TASK_RESULT, dict(sd), dict(headers)))
        want = [ser.join_views(v) for _n, v in ref.iter_encode_views(rmsg, rctx)]
        assert got == want, rnd
        outs = []
        for rx, blobs in ((port_rx, got), (ref_rx, want)):
            dec = rx.decoder()
            for blob in blobs:
                dec.on_item(*dec.decode_item(blob)[:2])
            outs.append(dec.finish(MessageKind.TASK_RESULT).payload)
        for name in sd:
            _bitwise(outs[0][name], outs[1][name])
    assert subnormal_residuals > 0
