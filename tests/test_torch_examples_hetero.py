"""``examples/torch/hetero_federation.py`` against the reference's
``examples/hetero_federation.py`` on the CPU: FedAsync and the tiered
policy under availability churn, with the adaptive filter's link ->
precision table (fp32 on fiber, blockwise8 on dsl, nf4 on 3g), print the
same bytes. Both are loaded by path, unedited, at their own constants;
the clients train in numpy in both and the wire is bitwise the
reference's, so there is no tolerance. One torch and one BLAS thread.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_examples import captured, load  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("policy", ["fedasync", "tiered"])
def test_stdout_is_the_references_byte_for_byte(policy):
    ref, port = load("hetero_federation", port=False), load("hetero_federation", port=True)
    _, want = captured(ref.run, policy)
    _, got = captured(port.run, policy, "cpu")
    assert got == want
    assert "site-5: 3g        -> nf4" in got and "-> blockwise8" in got
