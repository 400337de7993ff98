"""The dry run's time loops (``repro_torch.launch.dryrun``,
``models.ssm.cut_time_loops``): xlstm-125m's sLSTM recurrence (one step a
token) and mLSTM chunks (one a 256 tokens) run three, four and five of
their steps on meta, and the count — one step times the trip count —
equals the same step with every loop run in full: FLOPs, bytes and the
peak of live meta storage (a prefill that cuts the sLSTM scan, and a train
step, whose backward runs each step's too), at one chip and on a mesh over
a fake process group. Where the peak does not grow linearly with the
steps (DTensor's temporaries on a (2, 8) mesh), it is reported as unknown,
never extrapolated; and the totals add up leaf by leaf.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.specs import ShapePlan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _full(cfg, plan, mesh=None):
    """The step's counts with every loop run in full."""
    step, args = dryrun.build_step(cfg, plan, mesh)
    if mesh is not None:
        L.set_sharding_context(mesh, SH.DEFAULT_RULES)
    try:
        return dryrun._run_counted(step, args, mesh)
    finally:
        L.set_sharding_context(None, None)


def _xlstm():
    return get_smoke_config("xlstm-125m").with_overrides(num_layers=2)


@pytest.mark.parametrize("kind,seq", [("prefill", 1024), ("train", 64)])
def test_a_cut_time_loop_counts_as_the_full_loop(kind, seq):
    """xlstm-125m's sLSTM recurrence (seq steps) is cut (the mLSTM's
    seq / 256 chunks are too few to cut), and the count equals the full
    run's FLOPs, bytes and peak (one super-block: time)."""
    plan = ShapePlan("x", kind, seq, 2, "paper")
    cut = dryrun.count_step(_xlstm(), plan)
    full = _full(_xlstm(), plan)
    assert cut["trip_counts"] == [seq]
    assert cut["flops"] == full["flops"]
    assert cut["bytes"] == full["bytes"]
    assert cut["memory"]["peak_bytes"] == full["memory"]["peak_bytes"]
    assert "peak_unknown" not in cut


@pytest.mark.parametrize("shape,batch,peak_known", [((2, 4), 8, True), ((2, 8), 16, False)])
def test_a_cut_time_loop_on_a_mesh_counts_as_the_full_loop(shape, batch, peak_known):
    """On a mesh the per-device FLOPs and bytes of the cut loop equal the
    full loop's. Its peak does too where it grows linearly with the steps
    ((2, 4)); on (2, 8) DTensor's temporaries make the peak wander from
    step to step, and the count reports it as unknown, with the reason,
    instead of a number one step times n would make up."""
    plan = ShapePlan("x", "prefill", 64, batch, "paper")
    with dryrun.fake_process_group(shape[0] * shape[1]):
        mesh = dryrun.make_mesh(shape)
        cut = dryrun.count_step(_xlstm(), plan, mesh)
        full = _full(_xlstm(), plan, mesh)
    assert cut["trip_counts"] == [64]
    assert cut["flops"] == full["flops"]
    assert cut["bytes"] == full["bytes"]
    if peak_known:
        assert cut["memory"]["peak_bytes"] == full["memory"]["peak_bytes"]
        assert "peak_unknown" not in cut
    else:
        assert cut["memory"]["peak_bytes"] is None
        assert "memory.peak_bytes" in cut["peak_unknown"]


def test_loop_totals_add_one_step_times_the_trip_count_leaf_by_leaf():
    """base + (n - 3) (longer - base) per leaf; a collective kind that only
    the longer run issues counts from 0."""
    base = {"flops": 10.0, "collectives": {"all-gather": {"count": 2.0}}}
    longer = {"flops": 13.0, "collectives": {"all-gather": {"count": 2.0},
                                             "all-reduce": {"count": 1.0}}}
    other = {"flops": 11.0, "collectives": {"all-gather": {"count": 3.0}}}
    out = dryrun._loop_total(base, [(100, longer), (8, other)])
    assert out == {"flops": 10.0 + 97 * 3.0 + 5 * 1.0,
                   "collectives": {"all-gather": {"count": 2.0 + 5 * 1.0},
                                   "all-reduce": {"count": 97.0}}}
