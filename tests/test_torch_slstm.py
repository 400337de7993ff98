"""Port parity, the sLSTM scan (B8): the plain version
(``repro_torch.kernels.ref.slstm_scan``) and the CPU side of its wrapper
(``repro_torch.kernels.slstm_scan.slstm_scan``) against the reference.

On every case of ``kernels.cases.SLSTM_CASES`` (the sweep of
``tests/test_slstm_kernel.py``, full width, a head dim of 48, bf16 gate
inputs, three 256-step chunks, gate inputs at +-30):

* h against the reference's Pallas kernel (``slstm_scan_pallas``) in
  interpret mode;
* the final state (c, n, h, m), which the reference's kernel does not
  return, against a ``lax.scan`` over the reference's ``ssm._slstm_cell``
  from ``ssm.slstm_init_state`` — the form its ``XLSTMModel.prefill``
  keeps as the cache.

Tolerances are the reference test's own. Against the Pallas kernel,
which widens bf16 gate inputs to fp32 as the plain version does, rtol
2e-4 / atol 2e-5 for every case (the per-head products sum in other
orders). Against the cell scan the same at fp32, and 2e-2 with bf16 gate
inputs (the reference's cell rounds h to bf16 before its product; the
kernels keep it in fp32). Also: batch rows are independent, the CPU
wrapper is the plain version and counts no launch, and the wrapper
raises on what it does not take.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.kernels.slstm_scan import slstm_scan_pallas  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.cases import SLSTM_CASES, slstm_case, slstm_inputs  # noqa: E402
from repro_torch.kernels import slstm_scan as slstm_scan_module  # noqa: E402
from repro_torch.kernels.slstm_scan import slstm_scan  # noqa: E402

TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STATE = ("c", "n", "h", "m")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the sLSTM cell loops run thousands of
    tiny ops, and on a machine whose cores the suite's other workers keep
    busy, waking a pool of threads for each op turned a 0.7 s forward
    into 80 s. The arithmetic is the same either way."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(name):
    c = slstm_case(name)
    gx, r = slstm_inputs(name)
    gx_t = torch.from_numpy(gx).to(getattr(torch, c["dtype"]))
    return c, gx_t, torch.from_numpy(r)


def _jnp(t: torch.Tensor):
    """A torch tensor as a jax array of the same dtype and bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@functools.lru_cache(maxsize=None)
def _reference_state(name: str):
    """The reference's lax.scan over ``_slstm_cell`` on the case's inputs:
    h (B, S, D) and the final state."""
    c, gx, r = _case(name)
    cfg = ref_smoke_config("xlstm-125m").with_overrides(d_model=c["H"] * c["hd"],
                                                        num_heads=c["H"])
    B, S = c["B"], c["S"]
    gx_j, r_j = _jnp(gx), _jnp(r)
    p = {name: {"r": r_j[i]} for i, name in enumerate(("z", "i", "f", "o"))}
    gx_named = {name: gx_j[:, :, i].reshape(B, S, c["H"], c["hd"]).transpose(1, 0, 2, 3)
                for i, name in enumerate(("z", "i", "f", "o"))}

    def step(state, gx_slice):
        new = ref_ssm._slstm_cell(state, gx_slice, p, cfg)
        return new, new["h"]

    final, hs = jax.lax.scan(step, ref_ssm.slstm_init_state(cfg, B), gx_named)
    return np.asarray(hs.transpose(1, 0, 2, 3).reshape(B, S, -1)), {
        k: np.asarray(v) for k, v in final.items()}


@pytest.mark.parametrize("name", sorted(SLSTM_CASES))
def test_plain_h_matches_the_reference_kernel_in_interpret_mode(name):
    c, gx, r = _case(name)
    want = np.asarray(slstm_scan_pallas(_jnp(gx), _jnp(r), num_heads=c["H"], chunk=c["chunk"],
                                        interpret=True))
    h, _state = ref.slstm_scan(gx, r, c["H"])
    assert h.dtype == torch.float32 and tuple(h.shape) == want.shape
    np.testing.assert_allclose(h.numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("name", sorted(SLSTM_CASES))
def test_plain_final_state_matches_the_reference_cell_scan(name):
    c, gx, r = _case(name)
    want_h, want_state = _reference_state(name)
    h, state = ref.slstm_scan(gx, r, c["H"])
    np.testing.assert_allclose(h.numpy(), want_h, **TOL[c["dtype"]])
    for key, got in zip(STATE, state):
        assert tuple(got.shape) == (c["B"], c["H"], c["hd"]) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_state[key], err_msg=key,
                                   **TOL[c["dtype"]])


def test_batch_rows_are_independent():
    """Permuting batch rows permutes h and the state (the kernel's state
    resets per row, as the reference's does at chunk 0 of each row)."""
    _c, gx, r = _case("b3_s32_c32")
    h, state = slstm_scan(gx, r, num_heads=4, chunk=32)
    perm = torch.tensor([2, 0, 1])
    h_p, state_p = slstm_scan(gx[perm], r, num_heads=4, chunk=32)
    torch.testing.assert_close(h_p, h[perm], rtol=1e-6, atol=1e-7)
    for a, b in zip(state_p, state):
        torch.testing.assert_close(a, b[perm], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["b2_s32_c8", "bf16", "hd48"])
def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch(name):
    c, gx, r = _case(name)
    ops.reset_launch_counts()
    h, state = slstm_scan(gx, r, num_heads=c["H"], chunk=c["chunk"])
    h_p, state_p = ref.slstm_scan(gx, r, c["H"])
    assert torch.equal(h, h_p) and all(torch.equal(a, b) for a, b in zip(state, state_p))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_wrapper_raises_on_what_it_does_not_take(monkeypatch):
    gx = torch.zeros((1, 32, 4, 256))
    r = torch.zeros((4, 4, 64, 64))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        slstm_scan(gx, r, num_heads=4, chunk=24)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        slstm_scan(gx, r, num_heads=4)                 # S 32, default chunk 256
    with pytest.raises(ValueError, match=r"\(B, S, 4, D\)"):
        slstm_scan(gx[0], r, num_heads=4, chunk=8)
    with pytest.raises(ValueError, match=r"\(B, S, 4, D\)"):
        slstm_scan(torch.zeros((1, 32, 3, 256)), r, num_heads=4, chunk=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        slstm_scan(gx.half(), r, num_heads=4, chunk=8)
    with pytest.raises(ValueError, match="r must be float32"):
        slstm_scan(gx, r.double(), num_heads=4, chunk=8)
    with pytest.raises(ValueError, match=r"r must be \(4, 4, 64, 64\)"):
        slstm_scan(gx, r[:, :2], num_heads=4, chunk=8)
    with pytest.raises(ValueError, match="heads"):
        slstm_scan(gx, r, num_heads=3, chunk=8)
    # what only the kernel refuses, reached through tensors that are not on
    # the CPU (the meta device allocates nothing; it takes the plain version
    # since the dry run, so the CPU alone is made the plain device here and
    # meta stands in for CUDA on the launch branch)
    monkeypatch.setattr(slstm_scan_module, "PLAIN_DEVICES", ("cpu",))
    big = torch.empty((1, 32, 4, 2 * 257), device="meta")
    with pytest.raises(ValueError, match="head dim 257 > 256"):
        slstm_scan(big, torch.empty((4, 2, 257, 257), device="meta"), num_heads=2, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        slstm_scan(gx.to("meta"), r.to("meta"), num_heads=4, chunk=8)
