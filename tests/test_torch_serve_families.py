"""Port parity, serving every family: ``repro_torch.launch.serve.generate``
against ``repro.launch.serve.generate`` at smoke width on the eight
architectures the port added, with the reference's initial weights
carried across, stub patches for the VLM and stub frames for the
enc-dec (``extra``, as both packages' ``generate`` takes them).

* greedy tokens equal at prompt 32 (the masked softmax in both) and at a
  prefill of 128 rows with the reference's prefill through its Pallas
  flash kernel in interpret mode (backend ``pallas``, as
  ``tests/test_torch_serve.py`` routes it): prompt 128, or 112 after the
  VLM's 16 patches;
* the reference's quirks, mirrored (ROADMAP C10, C11): a VLM's replay
  holds the text prompt only, so its tokens do not depend on the patches
  (though its prefill logits do); an enc-dec's self-attention cache stays
  sized to the prompt, and every decode step writes its last slot; so
  does a window cache when the prompt is shorter than the window
  (recurrentgemma-2b's smoke window of 16 against a prompt of 8);
* ``python -m repro_torch.launch.serve --smoke --device cpu`` serves each
  architecture (zero frames / patches, as the reference's ``main``).

Tolerances: greedy tokens must be equal; caches within 1e-5 absolute +
1e-5 relative (fp32 products summed in other orders).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro.kernels import ops as ref_kops  # noqa: E402
from repro.launch.serve import generate as ref_generate  # noqa: E402
from repro.models import create_model as ref_create_model  # noqa: E402
from repro.utils.trees import flatten_state_dict as ref_flatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import create_model  # noqa: E402
from repro_torch.utils.trees import from_reference_state, unflatten_state_dict  # noqa: E402

NEW_ARCHS = ("stablelm-1.6b", "dbrx-132b", "whisper-small", "llama4-scout-17b-a16e",
             "recurrentgemma-2b", "granite-8b", "phi-3-vision-4.2b", "qwen2.5-32b")
BATCH, GEN, TOL = 2, 4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread (six test workers share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    ref_model = ref_create_model(ref_smoke_config(arch).with_overrides(remat=False))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat_np = {k: np.asarray(v) for k, v in ref_flatten(ref_params).items()}
    model = create_model(get_smoke_config(arch).with_overrides(remat=False))
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    params = unflatten_state_dict(from_reference_state(flat_np, "cpu", expect))
    return ref_model, ref_params, model, params


def _inputs(cfg, length: int, seed: int = 0):
    """Prompts and the ``extra`` inputs, numpy."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, length)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return prompts, extra


def _both(model, ref_model, ref_params, params, prompts, extra):
    want = np.asarray(ref_generate(ref_model, ref_params, jnp.asarray(prompts), gen_len=GEN,
                                   extra={k: jnp.asarray(v) for k, v in extra.items()} or None))
    got = serve.generate(model, params, torch.from_numpy(prompts), gen_len=GEN,
                         extra={k: torch.from_numpy(v) for k, v in extra.items()} or None)
    return got, want


@pytest.fixture
def through_pallas(monkeypatch):
    """Route the reference's full-sequence attention through its Pallas
    kernel in interpret mode; yields the list of kernel calls."""
    calls = []
    orig = ref_fa.flash_attention_pallas

    def interpreted(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, interpret=True, **kwargs)

    monkeypatch.setattr(ref_fa, "flash_attention_pallas", interpreted)
    monkeypatch.setattr(ref_kops, "_backend", "pallas")
    return calls


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_greedy_tokens_match_the_reference(arch):
    ref_model, ref_params, model, params = _models(arch)
    prompts, extra = _inputs(model.cfg, 32)
    ops.reset_launch_counts()
    got, want = _both(model, ref_model, ref_params, params, prompts, extra)
    assert got.dtype == torch.int32 and tuple(got.shape) == (BATCH, 32 + GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_matches_the_reference_through_its_pallas_prefill(arch, through_pallas):
    ref_model, ref_params, model, params = _models(arch)
    cfg = model.cfg
    length = 128 - cfg.num_patches if cfg.family == "vlm" else 128
    prompts, extra = _inputs(cfg, length, seed=2)
    got, want = _both(model, ref_model, ref_params, params, prompts, extra)
    np.testing.assert_array_equal(got.numpy(), want)
    assert through_pallas, "the reference did not reach its kernel"


def test_vlm_tokens_do_not_see_the_patches():
    """C10: generate replays the text prompt alone into the decode cache,
    so two sets of patches give the same tokens (both packages), though
    the prefill's logits differ."""
    ref_model, ref_params, model, params = _models("phi-3-vision-4.2b")
    prompts, extra = _inputs(model.cfg, 24, seed=3)
    other = {"patches": extra["patches"] * -2.0 + 1.0}
    runs = [_both(model, ref_model, ref_params, params, prompts, e) for e in (extra, other)]
    for got, want in runs:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())
    with torch.inference_mode():
        logits = [model.prefill(params, torch.from_numpy(prompts), torch.from_numpy(e["patches"]))
                  [0] for e in (extra, other)]
    assert not torch.allclose(logits[0], logits[1])


@pytest.mark.parametrize("arch, prompt, names", [
    ("whisper-small", 8, ("self_k", "self_v")),
    ("recurrentgemma-2b", 8, ("blocks.2_attn.k", "blocks.2_attn.v")),
])
def test_decode_past_a_prompt_sized_cache_writes_its_last_slot(arch, prompt, names):
    """C11: the enc-dec's prefill cache (and a window cache shorter than
    the window) is sized to the prompt; each decode step writes slot
    P - 1, as ``lax.dynamic_update_slice`` clamps it. Caches after each
    step equal the reference's."""
    from repro.utils.trees import flatten_state_dict as rflat
    from repro_torch.utils.trees import flatten_state_dict

    ref_model, ref_params, model, params = _models(arch)
    prompts, extra = _inputs(model.cfg, prompt, seed=4)
    rargs = [jnp.asarray(prompts)] + [jnp.asarray(v) for v in extra.values()]
    targs = [torch.from_numpy(prompts)] + [torch.from_numpy(v) for v in extra.values()]
    ref_logits, ref_cache = ref_model.prefill(ref_params, *rargs)
    with torch.inference_mode():
        _, cache = model.prefill(params, *targs)
    decode = jax.jit(ref_model.decode_step)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], axis=-1)).astype(np.int32)
    for step in range(3):
        before = {n: flatten_state_dict(cache)[n].clone() for n in names}
        ref_logits, ref_cache = decode(ref_params, ref_cache, jnp.asarray(tok),
                                       jnp.int32(prompt + step))
        with torch.inference_mode():
            _, cache = model.decode_step(params, cache, torch.from_numpy(tok), prompt + step)
        flat, rf = flatten_state_dict(cache), rflat(ref_cache)
        for n in names:
            t = flat[n]
            assert t.shape[-2] == prompt, n             # (..., P, kv_feat)
            torch.testing.assert_close(t[..., :prompt - 1, :], before[n][..., :prompt - 1, :],
                                       rtol=0, atol=0)
            assert not torch.equal(t[..., prompt - 1, :], before[n][..., prompt - 1, :]), n
            np.testing.assert_allclose(t.numpy(), np.asarray(rf[n]), rtol=TOL, atol=TOL)
        tok = np.asarray(jnp.argmax(ref_logits, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_each_architecture_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (2, 20) in ")
    tokens = [int(t) for t in out[1].strip("[]").split()]
    assert len(tokens) == 4 and all(0 <= t < get_smoke_config(arch).vocab_size for t in tokens)
