"""Port parity, the MoE layer (``repro_torch.models.moe`` against
``repro.models.moe``).

* ``_dispatch_tensors`` bitwise on crafted gates: exact ties between
  experts (the first index wins in both: ``lax.top_k`` and
  ``torch.argmax``), capacity overflow (tokens past an expert's buffer
  dropped), ties and overflow together, and random softmax gates. Every
  nonzero of ``combine`` is a gate value copied, so bitwise is the bar;
* ``load_balance_loss`` on tied gates: equal within 5e-7 relative, four
  fp32 ulps (two means and a sum over experts, each summed in another
  order; 1.2e-7 measured); its top-k takes the same experts (checked
  through a tie-breaking case whose loss differs if the order differs);
* ``moe_forward`` outputs and aux loss within 1e-5 (fp32 einsums in other
  orders), at prompt and at decode shapes (one token: one group of one,
  capacity ``ceil(k / E * 1.25)``), and the capacity formula;
* where the reference asserts the group split, the port raises
  ``ValueError``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread (six test workers share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _softmax_gates(G, T, E, seed):
    logits = np.random.default_rng(seed).standard_normal((G, T, E)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _tied_gates():
    """(1, 6, 4) gates with exact ties: equal top-2 pairs, a four-way tie,
    and a tie for second place."""
    g = np.array([[[0.4, 0.4, 0.1, 0.1],
                   [0.25, 0.25, 0.25, 0.25],
                   [0.1, 0.3, 0.3, 0.3],
                   [0.5, 0.2, 0.2, 0.1],
                   [0.4, 0.4, 0.1, 0.1],
                   [0.1, 0.1, 0.4, 0.4]]], np.float32)
    return g


def _overflow_gates():
    """(2, 8, 4) gates where every token prefers expert 2, then expert 0:
    expert 2's buffer fills and the rest overflow."""
    g = np.full((2, 8, 4), 0.1, np.float32)
    g[:, :, 2] = 0.6
    g[:, :, 0] = 0.2
    return g


#: name -> (gates, k, capacity)
DISPATCH_CASES = {
    "ties_k1": (_tied_gates, 1, 6),
    "ties_k2": (_tied_gates, 2, 6),
    "ties_k4_capacity2": (_tied_gates, 4, 2),
    "overflow_k1": (_overflow_gates, 1, 3),
    "overflow_k2": (_overflow_gates, 2, 3),
    "overflow_k2_capacity1": (_overflow_gates, 2, 1),
    "softmax_k2": (lambda: _softmax_gates(3, 16, 4, 0), 2, 10),
    "softmax_k4_e16": (lambda: _softmax_gates(2, 32, 16, 1), 4, 10),
}


@pytest.mark.parametrize("name", sorted(DISPATCH_CASES))
def test_dispatch_tensors_bitwise_equal_the_reference(name):
    make, k, capacity = DISPATCH_CASES[name]
    gates = make()
    want = np.asarray(ref_moe._dispatch_tensors(jnp.asarray(gates), k, capacity))
    got = moe._dispatch_tensors(torch.from_numpy(gates), k, capacity).numpy()
    assert got.shape == want.shape == gates.shape + (capacity,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name.startswith("overflow"):   # some token was dropped from some slot
        assert (got > 0).sum() < gates.shape[0] * gates.shape[1] * k


@pytest.mark.parametrize("name", ["ties_k1", "ties_k2", "overflow_k2", "softmax_k4_e16"])
def test_load_balance_loss_matches_the_reference(name):
    make, k, _capacity = DISPATCH_CASES[name]
    gates = make()
    want = float(ref_moe.load_balance_loss(jnp.asarray(gates), k))
    got = float(moe.load_balance_loss(torch.from_numpy(gates), k))
    assert got == pytest.approx(want, rel=5e-7, abs=0.0)


def test_load_balance_loss_breaks_ties_toward_the_lower_index():
    """Two tokens, gates (0.5, 0.5, 0, 0) and (0.9, 0.1, 0, 0): top-1 takes
    expert 0 for both when a tie goes to the lower index (loss 4 * 0.7 =
    2.8), and expert 1 for the first otherwise (loss 2.0)."""
    gates = np.array([[[0.5, 0.5, 0.0, 0.0], [0.9, 0.1, 0.0, 0.0]]], np.float32)
    got = float(moe.load_balance_loss(torch.from_numpy(gates), 1))
    assert got == pytest.approx(float(ref_moe.load_balance_loss(jnp.asarray(gates), 1)),
                                rel=5e-7, abs=0.0)
    assert got == pytest.approx(2.8, rel=1e-6)


def _layer(arch: str, seed: int):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.standard_normal((d, e)) * 0.5,
         "w_gate": rng.standard_normal((e, d, f)) * 0.05,
         "w_up": rng.standard_normal((e, d, f)) * 0.05,
         "w_down": rng.standard_normal((e, f, d)) * 0.05}
    return cfg, {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("shape", [(2, 256), (1, 512), (3, 1), (2, 64)])
def test_moe_forward_matches_the_reference(arch, shape):
    cfg, p = _layer(arch, 3)
    x = np.random.default_rng(4).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    want_y, want_aux = ref_moe.moe_forward(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, ref_smoke_config(arch))
    y, aux = moe.moe_forward(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                             cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=TOL, abs=TOL)


def test_capacity_follows_the_reference_formula(monkeypatch):
    """ceil(group * k / E * 1.25): 160 for smoke dbrx at 256 tokens
    (4 experts, top-2), 1 for one decode token."""
    seen = []
    orig = moe._dispatch_tensors
    monkeypatch.setattr(moe, "_dispatch_tensors",
                        lambda g, k, c: (seen.append((g.shape, c)), orig(g, k, c))[1])
    cfg, p = _layer("dbrx-132b", 5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    moe.moe_forward(torch.zeros(2, 256, cfg.d_model), tp, cfg)
    moe.moe_forward(torch.zeros(3, 1, cfg.d_model), tp, cfg)
    assert seen == [((2, 256, 4), 160), ((3, 1, 4), 1)]
    assert moe.GROUP_T == ref_moe.GROUP_T


def test_a_batch_that_does_not_split_into_groups_raises():
    cfg, p = _layer("dbrx-132b", 6)
    x = torch.zeros(1, 300, cfg.d_model)
    with pytest.raises(ValueError, match="groups of 256"):
        moe.moe_forward(x, {k: torch.from_numpy(v) for k, v in p.items()}, cfg)
