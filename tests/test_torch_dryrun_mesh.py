"""The dry run on a (2, 4) mesh over a fake process group of 8 ranks
(``repro_torch.launch.dryrun``): for a dense train step (qwen1.5-0.5b),
an MoE decode step (dbrx-132b), a recurrent one (recurrentgemma-2b) and
the xLSTM's train step (xlstm-125m, whose backward reaches
``aten.log_sigmoid_backward``, a strategy the dry run registers) at smoke
width and ``tests/test_dryrun_small.py``'s shrunken shapes, FLOPs and
bytes per device are positive, the bottleneck is a known one, per-device
FLOPs x 8 are at least the one-chip count less 2 % (devices repeat work;
they never skip it), the FSDP-sharded weights (``embed`` over ``data``)
are gathered, and the collectives have wire bytes; ``CommDebugMode`` and
the counter agree on every collective (the count raises otherwise). The
one-chip counts (FLOPs, bytes, peak) are pinned: the models' mesh path
(a sharding context) leaves the plain path as it was. whisper-small at
its full width (12 heads) but 2 + 2 layers decodes on a (2, 8) mesh,
whose ``model`` axis does not divide its heads: its cross-attention
splits the features into heads only once they are placed so the split
divides (torch 2.11 refuses the uneven split; the guard of
``tests/torch_mesh_guard.py`` holds the step to that). Each test tears its
group down (a process group is global to its process, and xdist reuses
workers).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_mesh_guard import report, run_guarded, small_plan  # noqa: E402

FLOP_RTOL = 0.02

#: one-chip (FLOPs, bytes, peak bytes) of each case, as counted before the
#: models had a mesh path (commit 56c6c60)
ONE_CHIP = {
    ("qwen1.5-0.5b", "train_4k"): (12079595520.0, 1157254256.0, 48874516.0),
    ("dbrx-132b", "decode_32k"): (62980096.0, 30654024.0, 20567360.0),
    ("recurrentgemma-2b", "decode_32k"): (34209792.0, 11889204.0, 9319968.0),
    ("xlstm-125m", "train_4k"): (16781410304.0, 4325352004.0, 90183280.0),
    ("whisper-small", "decode_32k"): (1063366656.0, 938459892.0, 699325473.0),
}
MESH_CASES = tuple(case for case in ONE_CHIP if case[0] != "whisper-small")


def _whisper_cut():
    """whisper-small at its full width, cut to 2 decoder + 2 encoder layers."""
    return get_config("whisper-small").with_overrides(num_layers=2, encoder_layers=2)


def _check_counts(cfg, plan, arch, shape, mesh):
    one = dryrun.roofline(cfg, plan, arch=arch)
    assert (one["counted_flops"], one["counted_bytes"],
            one["memory_per_device"]["peak_bytes"]) == ONE_CHIP[(arch, shape)]
    out = dryrun.roofline(cfg, plan, arch=arch, mesh=mesh)
    chips = mesh.size()
    assert out["chips"] == chips and out["mesh"] == "x".join(map(str, mesh.shape))
    assert out["counted_flops"] > 0 and out["counted_bytes"] > 0
    assert out["bottleneck"] in ("compute", "memory", "collective")
    assert out["counted_flops"] * chips >= (1 - FLOP_RTOL) * one["counted_flops"]
    assert out["collective_detail"]["all-gather"]["count"] > 0      # FSDP: embed over data
    assert out["collective_wire_bytes"] > 0 and out["collective_s"] > 0


@pytest.mark.parametrize("arch,shape", MESH_CASES)
def test_a_2x4_mesh_counts_per_device(arch, shape):
    cfg, plan = small_plan(get_smoke_config(arch), shape)
    with dryrun.fake_process_group(8):
        _check_counts(cfg, plan, arch, shape, dryrun.make_mesh((2, 4)))


def test_cross_attention_heads_split_on_a_mesh_that_does_not_divide_them(monkeypatch):
    """12 heads on a ``model`` axis of 8: the decode step counts, and no
    view splits a sharded dim unevenly (nor does any other op torch 2.11
    refuses)."""
    cfg, plan = small_plan(_whisper_cut(), "decode_32k")
    assert cfg.num_heads % 8
    with dryrun.fake_process_group(16):
        mesh = dryrun.make_mesh((2, 8))
        step, args = dryrun.build_step(cfg, plan, mesh)
        found = run_guarded(step, args, mesh, monkeypatch).found
        assert not found, report(found)
        _check_counts(cfg, plan, "whisper-small", "decode_32k", mesh)
