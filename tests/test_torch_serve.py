"""Port parity, the serving slice: smoke llama3.2-1b (GQA) and qwen1.5-0.5b
(MHA with QKV bias), with the reference's initial weights
(``model.init(PRNGKey(0))``) carried across by ``from_reference_state``.
For each, the port's ``prefill`` (logits and cache), three
``decode_step``s and ``generate``'s greedy tokens against the reference's:

* at prompt 32 (the masked-softmax path in both packages);
* at prompt 128, with the reference's prefill run *through its Pallas
  flash kernel* (backend ``pallas``, ``flash_attention_pallas`` in
  interpret mode) — the routing that ``tests/test_flash_integration.py``
  means to test but does not reach, since that test sets the backend to
  ``pallas_interpret`` and the model routes only on ``pallas``;
* with ``sliding_window=64`` at prompt 256, where decode continues from
  the prefill's rolling window cache.

Tolerances, and why: logits and caches within 1e-5 absolute + 1e-5
relative. The two packages sum their fp32 matrix products in different
orders (and the Pallas kernel its online softmax), so values differ in
the last bits; greedy tokens must be equal.

Also: the CLI runs on the CPU when asked and raises without CUDA when
not, and sampled decoding is deterministic for a seeded generator. The
other families, and ``generate``'s ``extra`` (frames, patches), are held
to the reference in ``tests/test_torch_serve_families.py``.
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

ARCHS = ("llama3.2-1b", "qwen1.5-0.5b")
#: name -> (prompt length, sliding window, reference prefill through Pallas)
SETTINGS = {"prompt32": (32, None, False), "prompt128_pallas": (128, None, True),
            "window64_prompt256": (256, 64, False)}
BATCH, GEN, TOL = 2, 4, 1e-5


@functools.lru_cache(maxsize=None)
def _models(arch: str, window):
    cfg = ref_smoke_config(arch).with_overrides(remat=False, sliding_window=window)
    ref_model = ref_create_model(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat_np = {k: np.asarray(v) for k, v in ref_flatten(ref_params).items()}
    model = create_model(get_smoke_config(arch).with_overrides(remat=False,
                                                               sliding_window=window))
    expect = {k: (s, torch.float32) for k, s in model.param_shapes().items()}
    params = unflatten_state_dict(from_reference_state(flat_np, "cpu", expect))
    return ref_model, ref_params, model, params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file's models. The suite runs
    six workers on a shared CPU, and a pool per core in each
    oversubscribes it (see ``tests/test_torch_slice_legacy.py``). The
    checks compare logits and caches within their stated tolerances."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _prompts(vocab: int, length: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, vocab, (BATCH, length)).astype(np.int32)


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


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, setting, request):
    P, window, pallas = SETTINGS[setting]
    calls = request.getfixturevalue("through_pallas") if pallas else None
    ref_model, ref_params, model, params = _models(arch, window)
    prompts = _prompts(model.cfg.vocab_size, P)
    ref_logits, ref_cache = ref_model.prefill(ref_params, jnp.asarray(prompts))
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(prompts))
    if pallas:   # the reference's layer scan traces its body, and the kernel, once
        assert len(calls) == 1, "the reference did not reach its kernel"
    _close(logits, ref_logits, "prefill logits")
    assert set(cache) == set(ref_cache)
    for name in cache:
        assert tuple(cache[name].shape) == ref_cache[name].shape, name
        _close(cache[name], ref_cache[name], f"prefill cache {name}")

    # three decode steps: a window model decodes on from its prefill cache,
    # a full-attention one (whose prefill cache is sized to the prompt)
    # from a fresh cache, as generate() uses them
    if window is None:
        ref_cache = ref_model.init_cache(BATCH, 8)
        cache = model.init_cache(BATCH, 8, "cpu")
        steps = [(prompts[:, t:t + 1], t) for t in range(3)]
    else:
        tok = np.asarray(jnp.argmax(ref_logits[:, -1:], axis=-1)).astype(np.int32)
        steps = [(tok, P + t) for t in range(3)]
    decode = jax.jit(ref_model.decode_step)
    for t, (tok, pos) in enumerate(steps):
        ref_logits, ref_cache = decode(ref_params, ref_cache, jnp.asarray(tok), jnp.int32(pos))
        with torch.inference_mode():
            logits, cache = model.decode_step(params, cache, torch.from_numpy(tok), pos)
        _close(logits, ref_logits, f"decode step {t} logits")
        for name in cache:
            _close(cache[name], ref_cache[name], f"decode step {t} cache {name}")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_match_reference(arch, setting, request):
    P, window, pallas = SETTINGS[setting]
    calls = request.getfixturevalue("through_pallas") if pallas else None
    ref_model, ref_params, model, params = _models(arch, window)
    prompts = _prompts(model.cfg.vocab_size, P)
    want = np.asarray(ref_generate(ref_model, ref_params, jnp.asarray(prompts), gen_len=GEN))
    ops.reset_launch_counts()
    got = serve.generate(model, params, torch.from_numpy(prompts), gen_len=GEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (BATCH, P + GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    if pallas:
        assert len(calls) == 1
    # on the CPU the flash route is never taken, even at multiples of 128
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_sampled_decoding_is_seeded():
    """``greedy=False`` draws from the softmax with a torch.Generator: its
    bits are not ``jax.random.categorical``'s, so only shape, range and
    determinism are checked."""
    _, _, model, params = _models("llama3.2-1b", None)
    prompts = torch.from_numpy(_prompts(model.cfg.vocab_size, 16))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(serve.generate(model, params, prompts, gen_len=6, greedy=False,
                                   generator=gen))
    assert torch.equal(runs[0], runs[1]) and tuple(runs[0].shape) == (BATCH, 22)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < model.cfg.vocab_size
    with pytest.raises(ValueError, match="Generator"):
        serve.generate(model, params, prompts, gen_len=2, greedy=False)


def test_cli_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (4, 48) in ")
    tokens = [int(t) for t in out[1].strip("[]").split()]
    assert len(tokens) == 16


def test_cli_without_a_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])
