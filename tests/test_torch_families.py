"""Port parity, the model families: every architecture the port added to
``repro_torch.configs`` (dense stablelm-1.6b, granite-8b, qwen2.5-32b;
MoE dbrx-132b, llama4-scout-17b-a16e; the RG-LRU hybrid recurrentgemma-2b;
the enc-dec whisper-small; the VLM phi-3-vision-4.2b) against the JAX
package at smoke width, with the reference's initial weights
(``model.init(PRNGKey(0))``) carried across by ``from_reference_state``.

* configs: equal to the reference's field by field (dtype fields by
  name), ``ARCH_IDS`` in the reference's order;
* parameters: names and shapes of ``param_shapes`` equal to the
  reference's flat state dict; ``param_count``, ``active_param_count``
  (full configs) and ``tree_param_count`` (smoke weights) equal;
* ``forward`` logits and aux loss, ``loss``, ``prefill`` logits and cache
  and three ``decode_step``s (logits and cache) match the reference's.
  recurrentgemma-2b also runs at 5 layers (one super-block and a tail of
  two RG-LRU layers).

Tolerances, and why: logits, caches, aux and loss within 1e-5 absolute +
1e-5 relative. The packages sum their fp32 matrix products in different
orders (XLA's dot vs ATen's) and the RG-LRU scan combines in the same
tree but may contract products differently, so values differ in the
last bits (~5e-7 measured).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import active_param_count as ref_active_param_count  # noqa: E402
from repro.models import create_model as ref_create_model  # noqa: E402
from repro.models import param_count as ref_param_count  # noqa: E402
from repro.utils.trees import flatten_state_dict as ref_flatten  # noqa: E402
from repro.utils.trees import tree_param_count as ref_tree_param_count  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    DecoderLM,
    EncDecModel,
    GriffinModel,
    XLSTMModel,
    active_param_count,
    create_model,
    param_count,
)
from repro_torch.utils.trees import (  # noqa: E402
    flatten_state_dict,
    from_reference_state,
    tree_param_count,
    unflatten_state_dict,
)

NEW_ARCHS = ("stablelm-1.6b", "dbrx-132b", "whisper-small", "llama4-scout-17b-a16e",
             "recurrentgemma-2b", "granite-8b", "phi-3-vision-4.2b", "qwen2.5-32b")
#: the smoke configs, and recurrentgemma-2b at 5 layers so that its tail runs
VARIANTS = {**{a: (a, {}) for a in NEW_ARCHS},
            "recurrentgemma-2b-tail": ("recurrentgemma-2b", {"num_layers": 5})}
BATCH, PROMPT, TOL = 2, 32, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs six workers on a shared
    CPU, and a pool per core in each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _models(variant: str):
    arch, over = VARIANTS[variant]
    ref_model = ref_create_model(ref_smoke_config(arch).with_overrides(remat=False, **over))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat_np = {k: np.asarray(v) for k, v in ref_flatten(ref_params).items()}
    model = create_model(get_smoke_config(arch).with_overrides(remat=False, **over))
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    params = unflatten_state_dict(from_reference_state(flat_np, "cpu", expect))
    return ref_model, ref_params, model, params


def _inputs(cfg, length: int = PROMPT, seed: int = 0):
    """Tokens and, for the enc-dec / VLM, stub frames / patches: numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, length)).astype(np.int32)
    extra = None
    if cfg.family == "encdec":
        extra = rng.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        extra = rng.standard_normal((BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return tokens, extra


def _args(tokens, extra, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return (conv(tokens),) + (() if extra is None else (conv(extra),))


def _close(got, want, what: str) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


def test_arch_ids_are_the_references_in_order():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_the_reference_field_by_field(arch, smoke):
    got = get_smoke_config(arch) if smoke else get_config(arch)
    want = ref_smoke_config(arch) if smoke else ref_get_config(arch)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("param_dtype", "activ_dtype"):
            assert str(g).split(".")[-1] == np.dtype(w).name, f.name
        else:
            assert g == w, (f.name, g, w)
    assert got.source and got.source == want.source


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_shapes_equal_the_references_state_dict(variant):
    ref_model, ref_params, model, params = _models(variant)
    want = {k: tuple(v.shape) for k, v in ref_flatten(ref_params).items()}
    assert model.param_shapes() == want
    assert tree_param_count(params) == ref_tree_param_count(ref_params)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_counts_equal_the_references(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert param_count(cfg) == ref_param_count(ref_cfg)
    assert active_param_count(cfg) == ref_active_param_count(ref_cfg)
    if cfg.family == "moe":
        assert active_param_count(cfg) < param_count(cfg)


def test_create_model_dispatches_every_family():
    want = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM, "ssm": XLSTMModel,
            "hybrid": GriffinModel, "encdec": EncDecModel}
    seen = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        seen[cfg.family] = type(create_model(cfg))
    assert seen == want
    with pytest.raises(ValueError, match="unknown family"):
        create_model(get_smoke_config("llama3.2-1b").with_overrides(family="rnn"))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_aux_and_loss_match_the_reference(variant):
    ref_model, ref_params, model, params = _models(variant)
    cfg = model.cfg
    tokens, extra = _inputs(cfg)
    ref_logits, ref_aux = ref_model.forward(ref_params, *_args(tokens, extra, "jax"))
    with torch.no_grad():
        logits, aux = model.forward(params, *_args(tokens, extra, "torch"))
    assert tuple(logits.shape) == (BATCH, PROMPT, cfg.vocab_size)
    _close(logits, ref_logits, "forward logits")
    _close(aux, ref_aux, "aux loss")
    if cfg.family == "moe":
        assert float(aux) > 0.0
    batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if extra is not None:
        batch_np["frames" if cfg.family == "encdec" else "patches"] = extra
    ref_total, ref_parts = ref_model.loss(ref_params, {k: jnp.asarray(v)
                                                       for k, v in batch_np.items()})
    with torch.no_grad():
        total, parts = model.loss(params, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    _close(total, ref_total, "loss")
    for name in ref_parts:
        _close(parts[name], ref_parts[name], name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_steps_match_the_reference(variant):
    ref_model, ref_params, model, params = _models(variant)
    cfg = model.cfg
    tokens, extra = _inputs(cfg, seed=1)
    ref_logits, ref_cache = ref_model.prefill(ref_params, *_args(tokens, extra, "jax"))
    with torch.inference_mode():
        logits, cache = model.prefill(params, *_args(tokens, extra, "torch"))
    _close(logits, ref_logits, "prefill logits")

    def check_cache(what):
        want = ref_flatten(ref_cache)
        got = flatten_state_dict(cache)
        assert set(got) == set(want), what
        for name in want:
            assert tuple(got[name].shape) == tuple(want[name].shape), (what, name)
            _close(got[name], want[name], f"{what} {name}")

    check_cache("prefill cache")
    # three decode steps on from the prefill's cache, as generate() does for
    # every model but a full-attention DecoderLM (tests/test_torch_serve.py)
    decode = jax.jit(ref_model.decode_step)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], axis=-1)).astype(np.int32)
    for t in range(3):
        pos = PROMPT + t
        ref_logits, ref_cache = decode(ref_params, ref_cache, jnp.asarray(tok), jnp.int32(pos))
        with torch.inference_mode():
            logits, cache = model.decode_step(params, cache, torch.from_numpy(tok), pos)
        _close(logits, ref_logits, f"decode step {t} logits")
        check_cache(f"decode step {t} cache")
        tok = np.asarray(jnp.argmax(ref_logits, axis=-1)).astype(np.int32)
