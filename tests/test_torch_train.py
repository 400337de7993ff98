"""Port parity, the centralized trainer: ``repro_torch.launch.train`` and
every family's loss and gradients against the JAX package, at smoke
width, from the reference's initial weights (``model.init(PRNGKey(0))``,
carried across with ``from_reference_state``).

* For dense (llama3.2-1b), MoE (dbrx-132b, llama4-scout), VLM
  (phi-3-vision-4.2b, with random patches), ssm (xlstm-125m), hybrid
  (recurrentgemma-2b) and enc-dec (whisper-small, with random frames):
  ``loss``, ``lm_loss`` and ``aux_loss`` within 1e-5 relative of the
  reference's, and each gradient leaf within 1e-5 of that leaf's own
  largest value in the reference's ``jax.value_and_grad(model.loss)``
  (``testing.gradient_counts``). The packages sum their fp32 products in
  different orders (XLA's dot and fusions against ATen's), so values
  differ in the last bits. The one exception is a leaf whose exact
  gradient is zero (``testing.zero_gradient_leaves``: xlstm-125m's sLSTM
  input-gate bias, which the sLSTM's normaliser cancels): both packages'
  values must be rounding, below 1e-7 of the whole gradient's largest
  (1.7e-9 to 2.1e-9 measured). Measured on an 8-core x86 CPU host: every
  other leaf within 4.4e-6 of its own largest, the mLSTM block's leaves
  too, at 3.6e-10 to 7.3e-7 of the whole gradient's largest. For MoE the
  routing (which slot of which expert each token takes, in every layer)
  is equal.
* ``cfg.remat`` on and off give bitwise-equal gradients: remat
  recomputes the same operations on the same inputs, and the CPU's
  kernels are deterministic.
* ``train_loop`` for 3 steps against ``repro.launch.train.train_loop``
  (the same ``SyntheticLMDataset`` batches), for dense, MoE, ssm and
  enc-dec (the loop is family-blind): loss histories within 1e-5
  relative, and the final weights within C1's bound
  (``repro_torch.testing.c1_counts``: one blockwise8 step of the block,
  with AdamW's sign flips, 2 lr a step, for a few elements). The leaf
  whose exact gradient is zero is held to the sign-flip term alone
  (``testing.trained_counts``): AdamW normalises its rounding, so its
  steps are that rounding's reading (xlstm-125m's ``blocks.slstm.i.b``:
  2.7e-6 apart, where the term is 1.8e-3). The gradient test above holds
  the gradient itself. Measured on an 8-core x86 CPU host: no other
  element beyond the step bound.
* ``python -m repro_torch.launch.train --smoke --device cpu`` prints the
  reference's lines.
"""
import functools
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import create_model as ref_create_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.utils.trees import flatten_state_dict as ref_flatten  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import create_model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.utils.trees import (  # noqa: E402
    flatten_state_dict,
    from_reference_state,
    tree_leaves,
    unflatten_state_dict,
)

ARCHS = ("llama3.2-1b", "dbrx-132b", "llama4-scout-17b-a16e", "phi-3-vision-4.2b",
         "xlstm-125m", "recurrentgemma-2b", "whisper-small")
MOE_ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
#: the loop's own parts (schedule, AdamW, data, frames) are family-blind:
#: dense, MoE (its aux in the loss), ssm (a zero-gradient leaf) and enc-dec
#: (frames in every batch) cover them; the gradient tests cover every arch
LOOP_ARCHS = ("llama3.2-1b", "dbrx-132b", "xlstm-125m", "whisper-small")
BATCH, SEQ = 2, 32
#: loss, lm_loss and aux_loss: relative; gradients: relative to each leaf's
#: own largest value (testing.gradient_counts)
LOSS_TOL = GRAD_TOL = 1e-5
HISTORY_TOL = 1e-5
STEPS, LR = 3, 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread (port rule 7): the suite runs six workers
    on a shared CPU, and a pool per core in each oversubscribes it. No
    check depends on the pool's size."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's model, its weights and their flat numpy copy."""
    ref_model = ref_create_model(ref_smoke_config(arch))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat_np = {k: np.asarray(v) for k, v in ref_flatten(ref_params).items()}
    return ref_model, ref_params, flat_np


def _extra(cfg, batch: int, rng) -> dict:
    """Random frames (enc-dec) or patches (VLM); nothing otherwise."""
    n = {"encdec": cfg.encoder_seq, "vlm": cfg.num_patches}.get(cfg.family)
    if n is None:
        return {}
    key = "frames" if cfg.family == "encdec" else "patches"
    return {key: rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)}


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), **_extra(cfg, BATCH, rng)}


def _port_batch(batch_np: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch_np.items()}


def _port_loss_and_grads(arch: str, batch_np: dict, remat: bool = True):
    _, _, flat_np = _reference(arch)
    model = create_model(get_smoke_config(arch).with_overrides(remat=remat))
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    params = unflatten_state_dict(from_reference_state(flat_np, "cpu", expect))
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = model.loss(params, _port_batch(batch_np))
    grads = torch.autograd.grad(loss, leaves)
    names = list(flatten_state_dict(params))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def _close_rel(got, want, tol: float, what: str) -> None:
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want), (what, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    ref_model, ref_params, _ = _reference(arch)
    batch_np = _batch(ref_model.cfg)
    value_and_grad = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))
    (ref_loss, ref_metrics), ref_grads = value_and_grad(
        ref_params, {k: jnp.asarray(v) for k, v in batch_np.items()})
    loss, metrics, grads = _port_loss_and_grads(arch, batch_np)
    _close_rel(loss, ref_loss, LOSS_TOL, "loss")
    for name in ("lm_loss", "aux_loss"):
        _close_rel(metrics[name], ref_metrics[name], LOSS_TOL, name)
    if ref_model.cfg.family == "moe":
        assert float(metrics["aux_loss"]) > 0
    ref_flat = {k: torch.tensor(np.asarray(v)) for k, v in ref_flatten(ref_grads).items()}
    assert list(grads) == list(ref_flat)
    for name, got in grads.items():
        assert got.shape == ref_flat[name].shape and bool(torch.isfinite(got).all()), name
    counts = testing.gradient_counts(ref_flat, grads,
                                     testing.zero_gradient_leaves(ref_model.cfg), GRAD_TOL)
    assert counts["holds"], counts
    print(f"{arch}: loss {float(loss):.6f}, {len(grads)} gradient leaves, {counts}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_matches_the_reference(arch, monkeypatch):
    """Every layer sends every token to the same slots of the same experts:
    the nonzero pattern of the dispatch tensor, recorded in both packages."""
    ref_model, ref_params, _ = _reference(arch)
    batch_np = _batch(ref_model.cfg, seed=1)
    seen = {"ref": [], "port": []}
    ref_dispatch, port_dispatch = ref_moe._dispatch_tensors, port_moe._dispatch_tensors

    def ref_spy(gates, k, capacity):
        combine = ref_dispatch(gates, k, capacity)
        jax.debug.callback(lambda c: seen["ref"].append(np.asarray(c) > 0), combine,
                           ordered=True)
        return combine

    def port_spy(gates, k, capacity):
        combine = port_dispatch(gates, k, capacity)
        seen["port"].append(combine.detach().numpy() > 0)
        return combine

    monkeypatch.setattr(ref_moe, "_dispatch_tensors", ref_spy)
    monkeypatch.setattr(port_moe, "_dispatch_tensors", port_spy)
    ref_model.loss(ref_params, {k: jnp.asarray(v) for k, v in batch_np.items()})
    jax.effects_barrier()
    _port_loss_and_grads(arch, batch_np, remat=False)
    assert len(seen["ref"]) == len(seen["port"]) == ref_model.cfg.num_layers
    for layer, (want, got) in enumerate(zip(seen["ref"], seen["port"])):
        assert got.shape == want.shape and want.any()
        assert np.array_equal(got, want), f"layer {layer}: routing differs"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_bitwise_equal_gradients(arch):
    batch_np = _batch(_reference(arch)[0].cfg, seed=2)
    on = _port_loss_and_grads(arch, batch_np, remat=True)
    off = _port_loss_and_grads(arch, batch_np, remat=False)
    assert on[0].numpy().tobytes() == off[0].numpy().tobytes()
    for name, g in on[2].items():
        assert g.numpy().tobytes() == off[2][name].numpy().tobytes(), name


@pytest.mark.parametrize("arch", LOOP_ARCHS)
def test_train_loop_matches_the_references(arch, capsys):
    ref_model, _, flat_np = _reference(arch)
    cfg = ref_model.cfg
    extra = _extra(cfg, BATCH, np.random.default_rng(3)) or None
    ref_params, ref_history = ref_train.train_loop(
        cfg, steps=STEPS, batch_size=BATCH, seq_len=SEQ, lr=LR,
        params=ref_model.init(jax.random.PRNGKey(0)), log_every=1, extra_batch=extra)
    ref_lines = capsys.readouterr().out.splitlines()
    params, history = port_train.train_loop(
        get_smoke_config(arch), steps=STEPS, batch_size=BATCH, seq_len=SEQ, lr=LR,
        params=flat_np, log_every=1, extra_batch=extra, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(history) == len(ref_history) == STEPS
    np.testing.assert_allclose(history, ref_history, rtol=HISTORY_TOL)
    pattern = re.compile(r"step +(\d+) loss \d+\.\d{4} \(\d+ ms\)")
    assert [pattern.fullmatch(x).group(1) for x in lines] == \
        [pattern.fullmatch(x).group(1) for x in ref_lines] == ["0", "1", "2"]
    want = {k: torch.tensor(np.asarray(v)) for k, v in ref_flatten(ref_params).items()}
    got = {k: v.detach() for k, v in flatten_state_dict(params).items()}
    assert list(got) == list(want)
    moved = sum(not torch.equal(got[k], torch.tensor(flat_np[k])) for k in got)
    assert moved == len(got)
    # a leaf whose exact gradient is zero is held to AdamW's sign-flip
    # term, C1's bound the rest
    counts = testing.trained_counts(want, got, testing.zero_gradient_leaves(cfg),
                                    sign_flips=2 * LR * STEPS)
    print(f"{arch}: histories {history} / {ref_history}; {counts}")
    assert counts["holds"], counts


def test_cli_prints_the_references_lines():
    """The CLI at smoke width on the CPU: a step line every ``log_every``
    (10) steps and the final line, in the reference's format."""
    args = ["--smoke", "--steps", "11", "--batch", "1", "--seq", "16"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PYTHONPATH": "src", "OMP_NUM_THREADS": "1", "PATH": ""}).stdout.splitlines()
    assert [line.split(" loss ")[0] for line in out[:2]] == ["step    0", "step   10"]
    assert re.fullmatch(r"step +\d+ loss \d+\.\d{4} \(\d+ ms\)", out[0])
    assert re.fullmatch(r"final loss: \d+\.\d{4} \(start \d+\.\d{4}\)", out[2])
    assert len(out) == 3
