"""``examples/torch/serve_batch.py`` against the reference's
``examples/serve_batch.py`` on the CPU: for each of its archs at smoke
width (qwen1.5-0.5b's KV cache, xlstm-125m's recurrent state,
recurrentgemma-2b's window), the reference's weights (its
``model.init(PRNGKey(0))``, recorded as its ``main`` calls ``generate``)
carried across give the same greedy tokens, prompt included, and the
same printed tokens. One torch thread.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.utils.trees import from_reference_state, unflatten_state_dict  # noqa: E402
from torch_examples import captured, load  # noqa: E402

TOKENS = re.compile(r"^(\S+)\s.*-> (\[.*\])$", re.MULTILINE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference_runs():
    """arch -> (flat numpy params, generated tokens) from the reference's main."""
    from repro.utils.trees import flatten_state_dict

    ref = load("serve_batch", port=False)
    runs = []
    generate = ref.generate

    def recording(model, params, prompts, **kwargs):
        out = generate(model, params, prompts, **kwargs)
        runs.append(({k: np.asarray(v) for k, v in flatten_state_dict(params).items()},
                     np.asarray(out)))
        return out

    ref.generate = recording
    _, printed = captured(ref.main)
    return dict(zip([a for a, _ in TOKENS.findall(printed)], runs)), printed


def test_greedy_tokens_are_the_references(reference_runs):
    runs, printed = reference_runs
    port = load("serve_batch", port=True)
    assert list(runs) == list(port.ARCHS)
    lines = []
    for arch, (flat, want) in runs.items():
        model = port.build(arch)
        expect = {name: (shape, model.cfg.param_dtype)
                  for name, shape in model.param_shapes().items()}
        params = unflatten_state_dict(from_reference_state(flat, "cpu", expect))
        out, line = captured(port.serve, arch, "cpu", params)
        np.testing.assert_array_equal(out.numpy(), want)
        lines.append(line)
    assert TOKENS.findall("".join(lines)) == TOKENS.findall(printed)
