"""Port parity, the job runner over every model family: ``repro_torch.fl.job``
builds each spec's model by family (``models.create_model``), as
``repro.fl.job`` does, at smoke width.

* ``initial_weights`` gives the reference's item names and shapes for
  all eleven archs.
* ``run_job`` of the blockwise8 federation (quantized downlink,
  quantized + crc32 uplink, streaming int8 fold; 2 clients, 1 round of
  one local step) for xlstm-125m, recurrentgemma-2b, dbrx-132b and
  phi-3-vision-4.2b from the reference's weights:
  - with fixed updates (``testing.fixed_train_fn``), the final weights and
    the wire bytes bitwise the reference's;
  - trained, the per-client losses within 1e-4 relative and the weights
    within one quantization step of their block + 1e-5 relative, the
    round-1 bound of ``tests/test_torch_slice.py``: the packages' autograd
    sums differ in the last bits, which can flip an int8 code at a .5
    boundary, moving the average by at most one step, absmax_b / 127.
    A leaf whose exact gradient is zero (``testing.zero_gradient_leaves``:
    xlstm-125m's ``blocks.slstm.i.b``, which the sLSTM's normaliser
    cancels) takes AdamW steps that are its rounding's reading; it is
    held to one step + AdamW's sign-flip term, 2 lr a local step (8.9e-6
    apart, where that bound is 6e-3).
* whisper-small's spec raises ``KeyError: 'frames'`` in both packages,
  from the first local step: the job's data has tokens and labels only,
  and the enc-dec's loss reads frames. Both build the job first.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.fl import job as ref_job  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.fl import job as port_job  # noqa: E402
from repro_torch.kernels.ref import BLOCK8  # noqa: E402

SPEC = {
    "smoke": True, "rounds": 1, "clients": 2, "local_steps": 1, "batch": 2, "seq": 16,
    "partition": "iid",
    "pipeline": {"task_data_out": ["quantize:blockwise8"],
                 "task_result_out": ["quantize:blockwise8", "crc32"]},
    "aggregator": "quantized-fedavg", "server_streaming_agg": True,
    "transmission": "container", "driver": "loopback", "chunk_mb": 1, "seed": 0,
    "lr": 3e-3,
}
RUN_ARCHS = ("xlstm-125m", "recurrentgemma-2b", "dbrx-132b", "phi-3-vision-4.2b")
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread (port rule 7): the suite runs six workers
    on a shared CPU. Fixed-update runs do no matrix products, and trained
    runs are held to stated bounds, so no check depends on the pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spec(arch: str) -> dict:
    return {**SPEC, "arch": arch}


def _as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_every_arch_is_a_job_arch():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 11


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_initial_weights_have_the_references_names_and_shapes(arch):
    want = ref_job.initial_weights(_spec(arch))
    got = port_job.initial_weights(_spec(arch), device="cpu")
    assert list(got) == list(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(np.shape(w)), name
        assert got[name].dtype == torch.float32


@pytest.mark.parametrize("arch", RUN_ARCHS)
def test_fixed_update_federation_bitwise_equals_the_reference(arch):
    spec = _spec(arch)
    init = {k: np.asarray(v) for k, v in ref_job.initial_weights(spec).items()}
    ref = ref_job.build_job(spec)
    port = port_job.build_job(spec, device="cpu", weights=init)
    for jb in (ref, port):
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = testing.fixed_train_fn(init, i, 0.05)
    ref_out, port_out = ref.run(), port.run()
    assert port_out["messages"] == ref_out["messages"] == 2 * spec["clients"]
    assert port_out["wire_bytes"] == ref_out["wire_bytes"]
    assert list(port_out["final_weights"]) == list(ref_out["final_weights"])
    for name, want in ref_out["final_weights"].items():
        assert _as_np(port_out["final_weights"][name]).tobytes() == \
            np.asarray(want).tobytes(), name


@pytest.mark.parametrize("arch", RUN_ARCHS)
def test_trained_federation_matches_the_reference_within_one_quant_step(arch):
    spec = _spec(arch)
    init = {k: np.asarray(v) for k, v in ref_job.initial_weights(spec).items()}
    ref_out = ref_job.run_job(spec)
    port_out = port_job.run_job(spec, device="cpu", weights=init)
    assert port_out["messages"] == ref_out["messages"]
    np.testing.assert_allclose(port_out["history"], ref_out["history"], rtol=LOSS_TOL)
    zero = testing.zero_gradient_leaves(get_smoke_config(arch))
    worst = 0.0
    for name, want_np in ref_out["final_weights"].items():
        want = torch.tensor(np.asarray(want_np))
        got = port_out["final_weights"][name]
        assert bool(torch.isfinite(got).all()), name
        step = testing.block_step(want, got, BLOCK8, 1 / 127)
        if name in zero:
            step = step + 2 * spec["lr"] * spec["local_steps"]
        err = (got - want).abs().reshape(-1)
        assert bool((err <= step + 1e-5 * want.abs().reshape(-1)).all()), name
        worst = max(worst, float((err / step.clamp_min(1e-30)).max()))
    print(f"{arch}: losses {port_out['history']} / {ref_out['history']}; zero-gradient "
          f"leaves {zero}; worst {worst:.4f} quantization steps")


def test_an_encdec_spec_raises_keyerror_frames_from_the_local_step_in_both():
    spec = _spec("whisper-small")
    init = {k: np.asarray(v) for k, v in ref_job.initial_weights(spec).items()}
    jobs = (ref_job.build_job(spec), port_job.build_job(spec, device="cpu", weights=init))
    for jb in jobs:
        with pytest.raises(KeyError, match="frames") as info:
            jb.run()
        assert info.value.args == ("frames",)
        assert any(frame.name == "train_fn" for frame in info.traceback)
