"""Port parity, the RG-LRU core (``repro_torch.models.rglru`` against
``repro.models.rglru``).

* ``rglru_scan`` without and with a carried state ``h0``, at lengths that
  take every branch of the associative scan's recursion (1, 2, odd and
  even, a power of two), against the reference's scan; and against the
  port's own step-by-step ``rglru_step``, as the reference's
  ``tests/test_models.py`` holds its own;
* ``rglru_step`` against the reference's;
* a recurrent block with a streaming state, and the two activations
  whose torch defaults differ from JAX's: softplus past torch's
  threshold of 20, and the tanh GeLU.

Tolerances, and why: rtol 1e-5, atol 1e-6, the reference's own for its
scan against its steps: the scan multiplies the decays in a tree, the
steps in a chain, and both packages may contract ``a * b + c`` differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread (six test workers share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))   # noqa: E731
    x = rng.standard_normal((B, S, W))
    r = sig(rng.standard_normal((B, S, W)))
    i = sig(rng.standard_normal((B, S, W)))
    lam = rng.standard_normal(W) * 3.0
    h0 = rng.standard_normal((B, W))
    return [a.astype(np.float32) for a in (x, r, i, lam, h0)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [1, 2, 3, 7, 16, 33, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_the_reference(S, with_h0):
    x, r, i, lam, h0 = _inputs(2, S, 8, S)
    h0_arg = h0 if with_h0 else None
    want_h, want_last = ref_rglru.rglru_scan(
        *map(jnp.asarray, (x, r, i, lam)), None if h0_arg is None else jnp.asarray(h0_arg))
    h, last = rglru.rglru_scan(*map(torch.from_numpy, (x, r, i, lam)),
                               None if h0_arg is None else torch.from_numpy(h0_arg))
    assert h.dtype == torch.float32 and tuple(h.shape) == x.shape
    _close(h, want_h)
    _close(last, want_last)
    # the scan against the port's own steps
    state = torch.from_numpy(h0) if with_h0 else torch.zeros(2, 8)
    for t in range(S):
        state = rglru.rglru_step(state, *(torch.from_numpy(a[:, t]) for a in (x, r, i)),
                                 torch.from_numpy(lam))
        np.testing.assert_allclose(h[:, t].numpy(), state.numpy(), rtol=RTOL, atol=ATOL)


def test_rglru_scan_continues_from_a_carried_state():
    x, r, i, lam, _ = _inputs(2, 16, 8, 2)
    t = [torch.from_numpy(a) for a in (x, r, i)]
    full, _ = rglru.rglru_scan(*t, torch.from_numpy(lam))
    _, mid = rglru.rglru_scan(*(a[:, :8] for a in t), torch.from_numpy(lam))
    second, _ = rglru.rglru_scan(*(a[:, 8:] for a in t), torch.from_numpy(lam), mid)
    np.testing.assert_allclose(second.numpy(), full[:, 8:].numpy(), rtol=RTOL, atol=ATOL)


def test_rglru_step_matches_the_reference():
    x, r, i, lam, h0 = _inputs(3, 1, 16, 9)
    want = ref_rglru.rglru_step(*map(jnp.asarray, (h0, x[:, 0], r[:, 0], i[:, 0], lam)))
    got = rglru.rglru_step(*map(torch.from_numpy, (h0, x[:, 0], r[:, 0], i[:, 0], lam)))
    _close(got, want)


def test_recurrent_block_with_a_streaming_state_matches_the_reference():
    cfg = get_smoke_config("recurrentgemma-2b")
    rng = np.random.default_rng(11)
    spec = rglru.rec_block_spec(cfg)
    p = {}
    for name, pd in spec.items():
        p[name] = (rng.standard_normal(pd.shape) * (0.5 if name == "lam" else 0.05)
                   ).astype(np.float32)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    state = {"conv": rng.standard_normal((2, rglru.CONV_K - 1, cfg.d_model)).astype(np.float32),
             "h": rng.standard_normal((2, cfg.d_model)).astype(np.float32)}
    want, want_state = ref_rglru.rec_block_forward(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        ref_smoke_config("recurrentgemma-2b"), {k: jnp.asarray(v) for k, v in state.items()})
    got, got_state = rglru.rec_block_forward(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want)
    for name in ("conv", "h"):
        _close(got_state[name], want_state[name])


def test_softplus_and_gelu_are_the_references():
    """jax.nn.softplus has no threshold (torch's switches to x past 20)
    and jax.nn.gelu defaults to the tanh approximation. GeLU within 1e-6
    absolute: below x = -3 its 1 + tanh(...) cancels, and the two
    libraries' tanh differ in the last bits there (4.4e-7 measured)."""
    x = np.linspace(-40.0, 40.0, 801, dtype=np.float32)
    np.testing.assert_allclose(rglru._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)
    np.testing.assert_allclose(rglru._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
