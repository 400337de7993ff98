"""``examples/torch/async_federation.py`` against the reference's
``examples/async_federation.py`` on the CPU: sync and FedBuff over the
event-driven runtime print the same bytes (the simulated makespan, the
model updates, the error, dispatches, dropouts, retries, wire MB and the
straggler). Both examples are loaded by path, unedited, at their own
constants; the toy clients train in numpy in both, and the port's wire
bytes are bitwise the reference's, so there is no tolerance. One torch
and one BLAS thread (six test workers share the CPU).
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


@pytest.mark.parametrize("policy", ["sync", "fedbuff"])
def test_stdout_is_the_references_byte_for_byte(policy):
    ref, port = load("async_federation", port=False), load("async_federation", port=True)
    _, want = captured(ref.run, policy)
    sim, got = captured(port.run, policy, "cpu")
    assert got == want
    assert sim.scheduler.stats.model_updates > 0
