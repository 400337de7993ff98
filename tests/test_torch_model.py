"""Port parity, model level: smoke llama3.2-1b with the reference's own
initial weights carried across by ``from_reference_state``.

Tolerances, and why:

* forward loss: 1e-5 relative;
* gradients: within 1e-6 of each tensor's largest |g|. The two packages
  sum the fp32 matrix products in different orders (XLA's dot vs ATen's),
  so activations and gradients differ in the last bits;
* one AdamW step (each package differentiating its own forward): every
  parameter within 1e-5 absolute + 1e-5 relative, plus what that
  gradient difference can move it through AdamW's first step. That step
  is ``lr * g / (|g| + eps)``, whose slope in ``g`` is
  ``lr * eps / (|g| + eps)**2``: where |g| is near eps (1e-8) a 1e-10
  gradient difference moves the parameter by ~1e-5 (two of the smoke
  model's 131,072 ``wo`` entries do), so the bound carries that term;
* the AdamW update given the same gradients: 1e-6 relative + 1e-7 absolute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.fl.job import initial_weights as ref_initial_weights  # noqa: E402
from repro.models import create_model  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.utils.trees import flatten_state_dict as ref_flatten  # noqa: E402
from repro.utils.trees import unflatten_state_dict as ref_unflatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import iid_partition  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.utils.trees import (  # noqa: E402
    flatten_state_dict,
    from_reference_state,
    tree_leaves,
    unflatten_state_dict,
)

ARCH = "llama3.2-1b"
SPEC = {"arch": ARCH, "smoke": True, "seed": 0}
LR = 3e-3


@pytest.fixture(scope="module")
def setup():
    flat_np = {k: np.asarray(v) for k, v in ref_initial_weights(SPEC).items()}
    cfg = get_smoke_config(ARCH)
    model = DecoderLM(cfg)
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    flat = from_reference_state(flat_np, "cpu", expect)
    batch_np = iid_partition(cfg.vocab_size, 32, 1, seed=0)[0].sample_at(4, 0)
    return flat_np, flat, model, batch_np


def test_from_reference_state_keeps_names_shapes_and_values(setup):
    flat_np, flat, model, _ = setup
    assert list(flat) == sorted(flat_np)
    assert set(flat) == set(model.param_shapes())
    for name, arr in flat_np.items():
        assert flat[name].dtype == torch.float32
        np.testing.assert_array_equal(flat[name].numpy(), arr)
    # the stacked-layer layout the wire depends on
    cfg = get_smoke_config(ARCH)
    assert tuple(flat["blocks.attn.wq"].shape) == (cfg.num_layers, cfg.d_model, cfg.q_feat)


def test_from_reference_state_rejects_mismatches(setup):
    flat_np, _, model, _ = setup
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    bad = dict(flat_np)
    bad.pop("embed.lm_head")
    with pytest.raises(ValueError, match="missing"):
        from_reference_state(bad, "cpu", expect)
    bad = dict(flat_np, **{"embed.lm_head": flat_np["embed.lm_head"].T})
    with pytest.raises(ValueError, match="shape"):
        from_reference_state(bad, "cpu", expect)
    bad = dict(flat_np, **{"embed.lm_head": flat_np["embed.lm_head"].astype(np.float16)})
    with pytest.raises(ValueError, match="dtype"):
        from_reference_state(bad, "cpu", expect)


def test_port_init_has_reference_names_shapes_and_scales(setup):
    flat_np, _, model, _ = setup
    mine = flatten_state_dict(model.init(0, "cpu"))
    assert list(mine) == list(flat_np)
    for name, arr in flat_np.items():
        assert tuple(mine[name].shape) == arr.shape
        # same initialiser per parameter: zeros stay zeros, std within 10%
        ref_std, my_std = float(arr.std()), float(mine[name].std())
        assert (ref_std == 0) == (my_std == 0), name
        if ref_std:
            assert abs(my_std - ref_std) <= 0.1 * ref_std, name


@pytest.fixture(scope="module")
def ref_step(setup):
    """The reference's loss, gradients and one AdamW step (jitted)."""
    flat_np, _, _, batch_np = setup
    model = create_model(ref_smoke_config(ARCH))
    params = ref_unflatten({k: jnp.asarray(v) for k, v in flat_np.items()})
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params, batch)
    new, _, _ = ref_adamw_update(params, grads, ref_adamw_init(params), jnp.float32(LR))
    return float(loss), ref_flatten(grads), ref_flatten(new)


def _port_loss_and_grads(flat, model, batch_np):
    p = unflatten_state_dict({k: v.clone().requires_grad_(True) for k, v in flat.items()})
    batch = {k: torch.as_tensor(v).long() for k, v in batch_np.items()}
    loss, _ = model.loss(p, batch)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return p, float(loss.detach()), list(grads)


def test_forward_loss_and_grads_match_reference(setup, ref_step):
    _, flat, model, batch_np = setup
    ref_loss, ref_grads, _ = ref_step
    _, loss, grads = _port_loss_and_grads(flat, model, batch_np)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for (name, want), got in zip(ref_grads.items(), grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_one_adamw_step_matches_reference(setup, ref_step):
    _, flat, model, batch_np = setup
    _, ref_grads, ref_new = ref_step
    p, _, grads = _port_loss_and_grads(flat, model, batch_np)
    g_mine = [g.clone() for g in grads]          # adamw_update clips in place
    adamw_update(p, grads, adamw_init(p), LR)
    mine = flatten_state_dict(p)
    eps = 1e-8
    for (name, want), g in zip(ref_new.items(), g_mine):
        want = np.asarray(want)
        g_ref = np.asarray(ref_grads[name])
        dg = np.abs(g.numpy() - g_ref)
        through_adam = LR * eps * dg / (np.abs(g_ref) + eps) ** 2
        err = np.abs(mine[name].detach().numpy() - want)
        bound = 1e-5 + 1e-5 * np.abs(want) + through_adam
        assert (err <= bound).all(), (name, float((err - bound).max()))


def test_adamw_update_matches_reference_on_the_same_gradients(setup):
    flat_np, flat, _, _ = setup
    rng = np.random.default_rng(3)
    grads_np = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
                for k, v in flat_np.items()}
    ref_params = ref_unflatten({k: jnp.asarray(v) for k, v in flat_np.items()})
    ref_grads = ref_unflatten({k: jnp.asarray(v) for k, v in grads_np.items()})
    state = ref_adamw_init(ref_params)
    p = unflatten_state_dict({k: v.clone() for k, v in flat.items()})
    opt = adamw_init(p)
    for _ in range(2):   # the second step exercises the bias corrections
        ref_params, state, _ = ref_adamw_update(ref_params, ref_grads, state, jnp.float32(LR))
        _, opt, _ = adamw_update(p, unflatten_state_dict(
            {k: torch.from_numpy(v.copy()) for k, v in grads_np.items()}), opt, LR)
    mine = flatten_state_dict(p)
    for name, want in ref_flatten(ref_params).items():
        np.testing.assert_allclose(mine[name].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
