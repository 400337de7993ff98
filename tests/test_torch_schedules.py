"""Port parity, the learning-rate schedules: ``repro_torch.optim.schedules``
against ``repro.optim.schedules``, under ``jax.jit`` and eager, at every
step from 0 to ``total + 5`` over a small grid of (base_lr, warmup,
total, min_frac).

The reference's two modes disagree with each other. Its ``train_loop``
runs a schedule inside a jitted step, where XLA's CPU backend turns each
division by a constant into a product with the fp32 reciprocal and
contracts ``min_frac + c * (1 + cos)`` into one fused multiply-add;
eager JAX divides and rounds the product and the sum apart. Near the end
of a cosine schedule ``1 + cos`` cancels, so the two differ by up to 33
ulps (min_frac 0, 10 steps). The port mirrors the jitted arithmetic,
which is the one the reference trains with.

Tolerances, and why:

* against the jitted reference, ``linear_warmup`` is bitwise (the same
  product, min and product); ``cosine_schedule`` is within 1 fp32 ulp:
  its ``cos`` is float64 ``cos`` rounded to fp32, the reference's the C
  library's ``cosf``, and these round apart at some arguments. The steps
  that are not bitwise are printed (on an 8-core x86 CPU host:
  at most one step of a schedule, by 1 ulp);
* against the eager reference, the port is as close as the jitted
  reference is, plus that ulp: ``|port - eager| <= |jit - eager| + 1
  ulp``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import schedules as ref_sched  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw_init,
    adamw_update,
    cosine_schedule,
    linear_warmup,
    schedules,
)

GRID = [  # (base_lr, warmup, total, min_frac)
    (3e-4, 1, 4, 0.1),
    (3e-4, 5, 50, 0.1),
    (1e-3, 0, 10, 0.0),
    (2.5e-3, 7, 7, 0.25),
    (0.1, 3, 100, 0.05),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread (port rule 7): the suite runs six workers
    on a shared CPU. Nothing here depends on the pool's size."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_values(schedule, total: int) -> np.ndarray:
    return np.array([schedule(torch.tensor(s, dtype=torch.int32)).numpy()
                     for s in range(total + 6)], dtype=np.float32)


def _ref_values(schedule, total: int, jit: bool) -> np.ndarray:
    fn = jax.jit(schedule) if jit else schedule
    return np.array([np.asarray(fn(jnp.int32(s))) for s in range(total + 6)],
                    dtype=np.float32)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in fp32 ulps between non-negative values."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("base_lr,warmup,total,min_frac", GRID)
def test_linear_warmup_is_bitwise_the_jitted_references(base_lr, warmup, total, min_frac):
    got = _port_values(linear_warmup(base_lr, warmup), total)
    want = _ref_values(ref_sched.linear_warmup(base_lr, warmup), total, jit=True)
    assert got.tobytes() == want.tobytes(), (got, want)


@pytest.mark.parametrize("base_lr,warmup,total,min_frac", GRID)
def test_cosine_schedule_is_within_one_ulp_of_the_jitted_references(base_lr, warmup, total,
                                                                    min_frac):
    got = _port_values(cosine_schedule(base_lr, warmup, total, min_frac), total)
    want = _ref_values(ref_sched.cosine_schedule(base_lr, warmup, total, min_frac), total,
                       jit=True)
    assert (got >= 0).all() and (want >= 0).all()
    ulps = _ulps(got, want)
    differ = [int(s) for s in np.nonzero(ulps)[0]]
    print(f"cosine_schedule{(base_lr, warmup, total, min_frac)} vs jit: "
          f"steps not bitwise {differ}")
    assert ulps.max() <= 1, (differ, got, want)


@pytest.mark.parametrize("name", ["linear_warmup", "cosine_schedule"])
@pytest.mark.parametrize("base_lr,warmup,total,min_frac", GRID)
def test_schedules_are_as_close_to_the_eager_reference_as_its_jit(base_lr, warmup, total,
                                                                  min_frac, name):
    args = (base_lr, warmup) if name == "linear_warmup" else (base_lr, warmup, total,
                                                               min_frac)
    got = _port_values(getattr(schedules, name)(*args), total)
    eager = _ref_values(getattr(ref_sched, name)(*args), total, jit=False)
    jitted = _ref_values(getattr(ref_sched, name)(*args), total, jit=True)
    gap = _ulps(jitted, eager)
    ulps = _ulps(got, eager)
    assert (ulps <= gap + 1).all(), (ulps, gap)
    print(f"{name}{args} vs eager: steps where eager != jit {np.nonzero(gap)[0].tolist()} "
          f"(up to {int(gap.max())} ulps); port within {int(ulps.max())} ulps")


def test_schedules_return_a_0_dim_fp32_tensor_on_the_steps_device():
    step = adamw_init({"w": torch.zeros(3)}).step
    for schedule in (linear_warmup(1e-3, 2), cosine_schedule(1e-3, 2, 10)):
        lr = schedule(step)
        assert lr.shape == () and lr.dtype == torch.float32 and lr.device == step.device
        assert float(lr) == 0.0  # step 0 trains at lr 0, as the reference's does


def test_adamw_takes_a_tensor_lr_bitwise_as_the_same_float():
    """A float lr and the same value as a 0-dim fp32 tensor give
    bitwise-equal parameters, moments and steps; the tensor is used as
    it is."""
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": {"c": rng.standard_normal(17).astype(np.float32)}}
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((64, 33), (17,))]
    lr = 3e-3
    runs = []
    for lr_arg in (lr, torch.tensor(lr, dtype=torch.float32)):
        params = {"a": torch.from_numpy(init["a"].copy()),
                  "b": {"c": torch.from_numpy(init["b"]["c"].copy())}}
        state = adamw_init(params)
        for _ in range(3):
            adamw_update(params, [torch.from_numpy(g.copy()) for g in grads], state, lr_arg)
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    assert torch.equal(s1.step, s2.step) and int(s1.step) == 3
    for x, y in ((p1["a"], p2["a"]), (p1["b"]["c"], p2["b"]["c"]),
                 (s1.m["a"], s2.m["a"]), (s1.v["b"]["c"], s2.v["b"]["c"])):
        assert x.numpy().tobytes() == y.numpy().tobytes()
