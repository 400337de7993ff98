"""The dry run on a (2, 4) mesh over a fake process group of 8 ranks
(``repro_torch.launch.dryrun``): for a dense train step (qwen1.5-0.5b),
an MoE decode step (dbrx-132b) and a recurrent one (recurrentgemma-2b) at
smoke width and ``tests/test_dryrun_small.py``'s shrunken shapes, FLOPs
and bytes per device are positive, the bottleneck is a known one,
per-device FLOPs x 8 are at least the one-chip count less 2 % (devices
repeat work; they never skip it), the FSDP-sharded weights (``embed`` over
``data``) are gathered, and the collectives have wire bytes. The group is
torn down by the module's fixture (a process group is global to its
process, and xdist reuses workers).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import ShapePlan, apply_variant, plan_for  # noqa: E402

#: tests/test_dryrun_small.py's shrunken (seq_len, global_batch)
SMALL = {"train_4k": (128, 8), "prefill_32k": (256, 4), "decode_32k": (256, 8)}
FLOP_RTOL = 0.02


def _plan(cfg, shape):
    seq, batch = SMALL[shape]
    plan = plan_for(cfg, shape)
    plan = ShapePlan(plan.shape_name, plan.kind, seq, batch, plan.variant)
    return apply_variant(cfg, plan), plan


MESH_CASES = (("qwen1.5-0.5b", "train_4k"), ("dbrx-132b", "decode_32k"),
              ("recurrentgemma-2b", "decode_32k"))


@pytest.fixture(scope="module")
def mesh_2x4():
    with dryrun.fake_process_group(8):
        yield dryrun.make_mesh((2, 4))


@pytest.mark.parametrize("arch,shape", MESH_CASES)
def test_a_2x4_mesh_counts_per_device(mesh_2x4, arch, shape):
    cfg, plan = _plan(get_smoke_config(arch), shape)
    one = dryrun.roofline(cfg, plan, arch=arch)
    out = dryrun.roofline(cfg, plan, arch=arch, mesh=mesh_2x4)
    assert out["chips"] == 8 and out["mesh"] == "2x4"
    assert out["counted_flops"] > 0 and out["counted_bytes"] > 0
    assert out["bottleneck"] in ("compute", "memory", "collective")
    assert out["counted_flops"] * 8 >= (1 - FLOP_RTOL) * one["counted_flops"]
    assert out["collective_detail"]["all-gather"]["count"] > 0      # FSDP: embed over data
    assert out["collective_wire_bytes"] > 0 and out["collective_s"] > 0
