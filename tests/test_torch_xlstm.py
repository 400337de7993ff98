"""Port parity, the xLSTM serving slice: smoke xlstm-125m with 4 layers (2
(mLSTM, sLSTM) super-blocks, d_model 256, 4 heads, vocab 512) and the
reference's initial weights (``XLSTMModel.init(PRNGKey(0))``) carried
across by ``from_reference_state``.

* ``forward`` logits and ``loss`` at sequence 16 (one mLSTM chunk) and 512
  (two chunks of 256), and a backward through the loss;
* the port's three mLSTM forms against one another, as the reference's
  tests hold its forms, and each against the reference's form;
* ``prefill`` logits and every cache leaf at prompts 32 and 512, then 4
  decode steps (logits and state);
* greedy tokens of ``repro_torch.launch.serve.generate`` against
  ``repro.launch.serve.generate`` at prompts 32 and 256;
* prefill at prompts 256 and 200 goes through the sLSTM-scan wrapper
  (its plain version here) once per super-block, with the whole prompt as
  one chunk — the stacking of gates and recurrent weights and the
  kernel's state output, against the reference's prefill.

Tolerances, and why: the packages sum their fp32 products in other
orders, ~1e-7 relative a product. Logits within 1e-5 absolute + 1e-5
relative (as ``tests/test_torch_serve.py``); the loss within 1e-6
relative. Cache leaves span ten decades (mLSTM C ~1e-5, sLSTM n ~1), so
each is held within 1e-4 relative + 1e-5 of its own largest magnitude.
The mLSTM forms use the reference tests' rtol 2e-4 / atol 2e-5.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.launch.serve import generate as ref_generate  # noqa: E402
from repro.models import create_model as ref_create_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.utils.trees import flatten_state_dict as ref_flatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import XLSTMModel, create_model, ssm  # noqa: E402
from repro_torch.utils.trees import (  # noqa: E402
    flatten_state_dict,
    from_reference_state,
    unflatten_state_dict,
)

BATCH, LAYERS, TOL = 2, 4, 1e-5
FORM_TOL = dict(rtol=2e-4, atol=2e-5)


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


@functools.lru_cache(maxsize=None)
def _models():
    cfg = ref_smoke_config("xlstm-125m").with_overrides(num_layers=LAYERS, remat=False)
    ref_model = ref_create_model(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat_np = {k: np.asarray(v) for k, v in ref_flatten(ref_params).items()}
    model = create_model(get_smoke_config("xlstm-125m").with_overrides(num_layers=LAYERS,
                                                                       remat=False))
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    params = unflatten_state_dict(from_reference_state(flat_np, "cpu", expect))
    return ref_model, ref_params, model, params


def _tokens(length: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, (BATCH, length)).astype(np.int32)


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _close_leaf(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32, what
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * scale, err_msg=what)


def _close_cache(cache, ref_cache, what: str) -> None:
    assert set(cache) == set(ref_cache) == {"mlstm", "slstm"}
    assert set(cache["mlstm"]) == {"C", "n", "m", "conv"}
    assert set(cache["slstm"]) == {"c", "n", "h", "m"}
    for block in cache:
        assert set(cache[block]) == set(ref_cache[block])
        for name, leaf in cache[block].items():
            _close_leaf(leaf, ref_cache[block][name], f"{what} {block}.{name}")


def test_weights_cross_over_under_the_reference_names():
    ref_model, ref_params, model, params = _models()
    flat = flatten_state_dict(params)
    assert isinstance(model, XLSTMModel) and len(flat) == 33
    assert sorted(flat)[0] == "blocks.mlstm.b_f"
    assert set(flat) == set(ref_flatten(ref_params))
    with pytest.raises(ValueError, match="even"):
        XLSTMModel(model.cfg.with_overrides(num_layers=3))


@pytest.mark.parametrize("seq", [16, 512])
def test_forward_logits_and_loss_match_reference(seq):
    ref_model, ref_params, model, params = _models()
    toks = _tokens(seq, seed=seq)
    ref_logits, _ = ref_model.forward(ref_params, jnp.asarray(toks))
    with torch.no_grad():
        logits, aux = model.forward(params, torch.from_numpy(toks))
    _close(logits, ref_logits, "forward logits")
    assert float(aux) == 0.0
    batch = {"tokens": toks, "labels": toks}
    # the reference's loss is this function of its forward's logits
    ref_loss = ref_layers.causal_lm_loss(ref_logits[:, :-1], jnp.asarray(toks)[:, 1:],
                                         ref_model.cfg.z_loss)
    with torch.no_grad():
        loss, parts = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert float(parts["lm_loss"]) == float(loss)


def test_loss_carries_gradients_through_the_cell_loop():
    """``loss`` is differentiable end to end: the sLSTM cell loop and the
    chunkwise mLSTM carry gradients (the kernel, which has none, is not on
    this path), and every parameter gets a finite gradient."""
    _, _, model, params = _models()
    toks = torch.from_numpy(_tokens(16, seed=3))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_state_dict(params).items()}
    loss, _ = model.loss(unflatten_state_dict(leaves), {"tokens": toks, "labels": toks})
    loss.backward()
    assert all(leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
               for leaf in leaves.values())
    assert float(leaves["blocks.slstm.z.r"].grad.abs().max()) > 0


def _mlstm_inputs(B=2, H=3, S=32, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    logi = (rng.standard_normal((B, H, S)) * 2.0).astype(np.float32)
    logf = np.array(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((B, H, S)) * 2.0 + 2.0, jnp.float32)))
    return q, k, v, logi, logf


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mlstm_forms_agree_with_one_another_and_the_reference(chunk):
    arrays = _mlstm_inputs()
    q, k, v, logi, logf = (torch.from_numpy(a) for a in arrays)
    B, H, S, hd = q.shape
    h_par = ssm.mlstm_parallel(q, k, v, logi, logf)
    state = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
             torch.full((B, H), -float("inf")))
    hs = []
    for t in range(S):
        state, h = ssm.mlstm_step(state, q[:, :, t], k[:, :, t], v[:, :, t], logi[:, :, t],
                                  logf[:, :, t])
        hs.append(h)
    h_chk, st = ssm.mlstm_chunkwise(q, k, v, logi, logf, chunk=chunk)
    np.testing.assert_allclose(h_par.numpy(), torch.stack(hs, dim=2).numpy(), **FORM_TOL)
    np.testing.assert_allclose(h_chk.numpy(), h_par.numpy(), **FORM_TOL)
    # continuing from a carried state gives the one-pass result
    half = min(chunk, 16)
    first = (q[:, :, :16], k[:, :, :16], v[:, :, :16], logi[..., :16], logf[..., :16])
    second = (q[:, :, 16:], k[:, :, 16:], v[:, :, 16:], logi[..., 16:], logf[..., 16:])
    h1, st1 = ssm.mlstm_chunkwise(*first, chunk=half)
    h2, st2 = ssm.mlstm_chunkwise(*second, chunk=half, state=st1)
    np.testing.assert_allclose(torch.cat([h1, h2], dim=2).numpy(), h_chk.numpy(), **FORM_TOL)
    for a, b in zip(st2, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FORM_TOL)
    # and each form against the reference's
    jx = [jnp.asarray(a) for a in arrays]
    ref_chk, ref_st = ref_ssm.mlstm_chunkwise(*jx, chunk=chunk)
    np.testing.assert_allclose(h_chk.numpy(), np.asarray(ref_chk), **FORM_TOL)
    for a, b in zip(st, ref_st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FORM_TOL)
    np.testing.assert_allclose(h_par.numpy(), np.asarray(ref_ssm.mlstm_parallel(*jx)),
                               **FORM_TOL)
    ref_state = (jnp.zeros((B, H, hd, hd)), jnp.zeros((B, H, hd)), jnp.full((B, H), -jnp.inf))
    ref_state, ref_h = ref_ssm.mlstm_step(ref_state, *(a[:, :, 0] for a in jx))
    state0, h0 = ssm.mlstm_step((torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
                                 torch.full((B, H), -float("inf"))),
                                *(a[:, :, 0] for a in (q, k, v, logi, logf)))
    np.testing.assert_allclose(h0.numpy(), np.asarray(ref_h), **FORM_TOL)
    for a, b in zip(state0, ref_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FORM_TOL)


@pytest.mark.parametrize("prompt", [32, 512])
def test_prefill_and_decode_steps_match_reference(prompt):
    ref_model, ref_params, model, params = _models()
    toks = _tokens(prompt)
    ref_logits, ref_cache = ref_model.prefill(ref_params, jnp.asarray(toks))
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks))
    _close(logits, ref_logits, "prefill logits")
    _close_cache(cache, ref_cache, "prefill")
    decode = jax.jit(ref_model.decode_step)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], axis=-1)).astype(np.int32)
    for t in range(4):
        ref_logits, ref_cache = decode(ref_params, ref_cache, jnp.asarray(tok),
                                       jnp.int32(prompt + t))
        with torch.inference_mode():
            logits, cache = model.decode_step(params, cache, torch.from_numpy(tok), prompt + t)
        _close(logits, ref_logits, f"decode step {t} logits")
        _close_cache(cache, ref_cache, f"decode step {t}")
        tok = np.asarray(jnp.argmax(ref_logits, axis=-1)).astype(np.int32)


def test_init_cache_matches_reference():
    ref_model, _, model, _ = _models()
    _close_cache(model.init_cache(BATCH, 64, "cpu"), ref_model.init_cache(BATCH, 64), "init")


@pytest.mark.parametrize("prompt", [32, 256])
def test_generate_greedy_tokens_match_reference(prompt):
    ref_model, ref_params, model, params = _models()
    toks = _tokens(prompt, seed=1)
    want = np.asarray(ref_generate(ref_model, ref_params, jnp.asarray(toks), gen_len=4))
    ops.reset_launch_counts()
    got = serve.generate(model, params, torch.from_numpy(toks), gen_len=4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (BATCH, prompt + 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the scan wrapper runs its plain version and launches nothing
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def _prefill_through_the_wrapper(monkeypatch, prompt):
    """Prefill with the scan wrapper counted: one call per super-block,
    the whole prompt as one chunk, and the prefill still matches the
    reference's (logits, every cache leaf)."""
    ref_model, ref_params, model, params = _models()
    toks = _tokens(prompt, seed=2)
    calls = []
    wrapper = ssm.slstm_scan

    def counted(gx, r, **kwargs):
        calls.append((tuple(gx.shape), tuple(r.shape), kwargs["chunk"]))
        return wrapper(gx, r, **kwargs)

    monkeypatch.setattr(ssm, "slstm_scan", counted)
    ref_logits, ref_cache = ref_model.prefill(ref_params, jnp.asarray(toks))
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks))
    assert calls == [((BATCH, prompt, 4, 256), (4, 4, 64, 64), prompt)] * (LAYERS // 2)
    _close(logits, ref_logits, "routed prefill logits")
    _close_cache(cache, ref_cache, "routed prefill")


def test_routed_prefill_goes_through_the_scan_wrapper(monkeypatch):
    _prefill_through_the_wrapper(monkeypatch, 256)


def test_prefill_of_any_length_goes_through_the_scan_wrapper(monkeypatch):
    """A prompt that is no multiple of the reference's chunk of 256 takes
    the wrapper too: the kernel walks the whole sequence in one launch."""
    _prefill_through_the_wrapper(monkeypatch, 200)


def test_cli_serves_xlstm_on_the_cpu(capsys):
    serve.main(["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (2, 20) in ")
    assert len(out[1].strip("[]").split()) == 4
