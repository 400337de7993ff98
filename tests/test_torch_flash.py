"""Port parity, flash attention: the port's plain version and its wrapper
on CPU tensors against the JAX package's attention oracle
(``repro.kernels.ref.attention``) and its Pallas kernel
(``flash_attention_pallas``, interpret mode, 64-row blocks) on a subset of
``kernels/cases.py::ATTENTION_CASES``.

Tolerances, and why:

* port plain version vs the reference's oracle: 1e-5 (fp32). The same
  formula in fp32; the two einsums sum in different orders;
* against the Pallas kernel: 2e-3 (fp32) and 2e-2 (bf16), the reference's
  own tolerances for its kernel against its oracle
  (``tests/test_flash_attention.py``): the online softmax rescales in
  another order, and bf16 outputs are rounded to 8 bits of mantissa.

The CUDA kernel is held against the same plain version on the card by
``tests/test_torch_cuda.py`` (marker ``cuda``) and ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.cases import attention_case, attention_inputs  # noqa: E402

#: two GQA groups, causal and non-causal, a window, Sq != Sk, the rows
#: that see no key, bf16, a query length that is no multiple of the
#: kernel's 128-row tile with a window that is no multiple of a key tile,
#: bf16 at hd 128, and the wide head dims 96 and 256 (MHA; MQA with a
#: window, non-causal, Sq != Sk; bf16 at both), and a GQA group of 6 at hd 128
SUBSET = ("group2", "group8", "non_causal", "window32", "cross_lengths",
          "fully_masked_rows", "bf16", "window100_sq320", "bf16_hd128",
          "hd96", "hd256_mqa_window", "hd256_non_causal", "hd256_cross_lengths",
          "bf16_hd96", "bf16_hd256", "group6_hd128", "hd256_window100_sq192",
          "hd96_group4_window40")
TOL_PALLAS = {"float32": 2e-3, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _pallas(name: str) -> np.ndarray:
    c = attention_case(name)
    dt = getattr(jnp, c["dtype"])
    q, k, v = (jnp.asarray(a, dt) for a in attention_inputs(name))
    out = flash_attention_pallas(q, k, v, causal=c["causal"], window=c["window"],
                                 block_q=64, block_k=64, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(name: str, fn):
    c = attention_case(name)
    dt = getattr(torch, c["dtype"])
    q, k, v = (torch.from_numpy(a).to(dt) for a in attention_inputs(name))
    out = fn(q, k, v, causal=c["causal"], window=c["window"])
    assert out.dtype == dt and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("name", SUBSET)
def test_plain_attention_matches_reference_oracle(name):
    c = attention_case(name)
    dt = getattr(jnp, c["dtype"])
    q, k, v = (jnp.asarray(a, dt) for a in attention_inputs(name))
    want = np.asarray(ref_ref.attention(q, k, v, causal=c["causal"], window=c["window"])
                      .astype(jnp.float32))
    got = _port(name, ref.attention)
    if c["dtype"] == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:   # both round the same fp32 result to bf16: at most one bf16 ulp apart
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("name", SUBSET)
def test_wrapper_on_cpu_matches_the_pallas_kernel(name):
    c = attention_case(name)
    before = FA.flash_attention.launches
    got = _port(name, FA.flash_attention)
    tol = TOL_PALLAS[c["dtype"]]
    np.testing.assert_allclose(got, _pallas(name), rtol=tol, atol=tol)
    assert FA.flash_attention.launches == before


def test_rows_that_see_no_key_average_every_value():
    """Past Sk + window - 1 no key is visible: every score is the finite
    fill, and the row is the mean of all values — in the oracle, the
    Pallas kernel and the port alike."""
    c = attention_case("fully_masked_rows")
    q, k, v = (torch.from_numpy(a) for a in attention_inputs("fully_masked_rows"))
    out = ref.attention(q, k, v, causal=True, window=c["window"])
    blind = c["sk"] + c["window"] - 1
    G = c["H"] // c["KV"]
    mean = v.mean(dim=2).repeat_interleave(G, dim=1)
    torch.testing.assert_close(out[:, :, blind:], mean[:, :, None].expand_as(out[:, :, blind:]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_pallas("fully_masked_rows")[:, :, blind:],
                               out[:, :, blind:].numpy(), rtol=2e-3, atol=2e-3)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    orig = ref.attention
    monkeypatch.setattr(ref, "attention", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in attention_inputs("group2"))
    FA.flash_attention(q, k, v)
    assert calls == [1]
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_backward_raises_not_implemented():
    """The kernel is forward-only, as the reference's is."""
    with pytest.raises(NotImplementedError, match="forward-only"):
        FA._FlashAttention.backward(None, torch.zeros(1))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad, match", [
    ((_meta(1, 4, 128, 64), _meta(1, 3, 128, 64), _meta(1, 3, 128, 64)), "groups"),
    ((_meta(1, 4, 128, 64), _meta(1, 2, 128, 128), _meta(1, 2, 128, 128)), "head dim"),
    ((_meta(1, 4, 128, 80), _meta(1, 2, 128, 80), _meta(1, 2, 128, 80)), "built for"),
    ((_meta(1, 4, 128, 64, dtype=torch.float16),) * 3, "float32 or bfloat16"),
    ((_meta(1, 4, 128, 64), _meta(1, 2, 128, 64, dtype=torch.bfloat16),
      _meta(1, 2, 128, 64, dtype=torch.bfloat16)), "dtypes differ"),
    ((_meta(1, 4, 128, 64), _meta(1, 2, 128, 64), _meta(1, 2, 64, 64)), "differ"),
    ((_meta(4, 128, 64), _meta(1, 2, 128, 64), _meta(1, 2, 128, 64)), "4-d"),
    ((_meta(1, 4, 128, 64), _meta(1, 2, 0, 64), _meta(1, 2, 0, 64)), "no keys"),
    ((_meta(65536, 1, 128, 64), _meta(65536, 1, 128, 64), _meta(65536, 1, 128, 64)),
     "batch 65536"),
    ((_meta(1, 1, 128 * 65536, 64), _meta(1, 1, 64, 64), _meta(1, 1, 64, 64)),
     "query tiles"),
    ((_meta(1, 1, 64, 256), _meta(1, 1, 2**30, 256), _meta(1, 1, 2**30, 256)),
     "key length"),
    ((_meta(1, 4, 128, 64), _meta(1, 2, 128, 64), _meta(1, 2, 128, 64)), "CUDA tensor"),
])
def test_non_cpu_tensors_are_checked_and_never_fall_back(bad, match, monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises — here meta
    tensors, which it checks and refuses. (Meta tensors take the plain
    version since the dry run, ``utils.device.PLAIN_DEVICES``; the CPU
    alone is made the plain device here, so that they stand in for CUDA
    tensors on the launch branch.)"""
    monkeypatch.setattr(FA, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(*bad)
