"""Every arch's smoke-width train, prefill and decode steps on a (2, 4)
mesh over a fake process group run no DTensor op that torch 2.11 refuses
(``tests/torch_mesh_guard.py``): no view flattens a sharded dim behind
the first or splits one unevenly, and nothing asks a shard for a partial
sum. torch 2.13 (the CPU tests' torch) carries such ops through, so without this
check a pair that counts here can fail on the card machine's 2.11; at
smoke width 4 heads divide the ``model`` axis of 4, so attention runs
heads-sharded, and 2 or 1 KV heads do not, so it runs sequence-sharded.
The archs of the ``--all`` sweep in sorted order, the first half here and
the rest in ``test_torch_dryrun_mesh_guard_rest.py`` (time).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.dryrun import sweep_pairs  # noqa: E402
from torch_mesh_guard import guard_smoke_steps, report  # noqa: E402

ARCHS = sorted({arch for arch, _ in sweep_pairs()})
HALF = ARCHS[:len(ARCHS) // 2]


@pytest.fixture(scope="module")
def mesh_2x4():
    with dryrun.fake_process_group(8):
        yield dryrun.make_mesh((2, 4))


@pytest.mark.parametrize("arch", HALF)
def test_no_op_that_torch_2_11_refuses(mesh_2x4, arch, monkeypatch):
    found = guard_smoke_steps(arch, mesh_2x4, monkeypatch)
    assert not found, report(found)
