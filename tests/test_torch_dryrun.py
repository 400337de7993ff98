"""Port parity, the dry run: ``repro_torch.launch.dryrun`` against the
reference's compiled dry run, and the meta-device rules it rests on.

* One chip: the port's meta FLOP count of train, prefill and decode
  (``torch.utils.flop_counter``'s formulas over the eager step) against
  ``repro.utils.hlo.module_flops`` of the reference's compiled step on a
  (1, 1) mesh, for a dense (granite-8b), an MoE (dbrx-132b) and a
  recurrent arch (xlstm-125m) at smoke width and the reference test's
  shrunken shapes (``tests/test_dryrun_small.py``). Both count matrix
  products only, and the counts are equal but for dbrx-132b's train
  step, held within 2 % (:data:`FLOP_RTOL`; reading 1.44 % above the
  reference's): under remat XLA recomputes only the forward values the
  backward reads, while ``torch.utils.checkpoint`` re-runs the block's
  forward in order up to the last saved tensor, products the backward
  does not read included; with remat off the two counts are equal.
* (A meta time loop counted as one step times its trip count:
  ``tests/test_torch_dryrun_loops.py``.)
* (A (2, 4) mesh over a fake process group: ``tests/test_torch_dryrun_mesh.py``.)
* The command line, and the kernels' rule on ``meta``: B7's and B8's
  wrappers take their plain versions (no launch); on the CPU as before.

The reference runs in a subprocess (its dry-run module fakes devices
through ``XLA_FLAGS`` when imported) with one thread.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.slstm_scan import slstm_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import INPUT_SHAPES, ShapePlan, apply_variant, plan_for  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: tests/test_dryrun_small.py's shrunken (seq_len, global_batch)
SMALL = {"train_4k": (128, 8), "prefill_32k": (256, 4), "decode_32k": (256, 8),
         "long_500k": (512, 2)}
ARCHS = ("granite-8b", "dbrx-132b", "xlstm-125m")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
FLOP_RTOL = 0.02

REFERENCE = r"""
import json, sys
import jax
import repro.launch.specs as SP
from repro.configs import get_smoke_config
from repro.launch import sharding as SH
from repro.launch.dryrun import build_step
from repro.models import layers as ML
from repro.utils import hlo as H
from repro.utils.compat import make_mesh

small = json.loads(sys.argv[1])
for name, (S, B) in small.items():
    SP.INPUT_SHAPES[name] = dict(SP.INPUT_SHAPES[name], seq_len=S, global_batch=B)
mesh = make_mesh((1, 1), ("data", "model"))
out = {}
for arch in sys.argv[2].split(","):
    cfg = get_smoke_config(arch)
    for shape in sys.argv[3].split(","):
        plan = SP.plan_for(cfg, shape)
        c2 = SP.apply_variant(cfg, plan)
        ML.set_sharding_context(mesh, SH.DEFAULT_RULES)
        step, args, in_sh, out_sh, donate = build_step(c2, plan, mesh)
        with mesh:
            compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=donate or ()).lower(*args).compile()
        ML.set_sharding_context(None, None)
        out[f"{arch}/{shape}"] = H.module_flops(compiled.as_text())
print(json.dumps(out))
"""


def _plan(cfg, shape):
    seq, batch = SMALL[shape]
    plan = plan_for(cfg, shape)
    plan = ShapePlan(plan.shape_name, plan.kind, seq, batch, plan.variant)
    return apply_variant(cfg, plan), plan


@pytest.fixture(scope="module")
def reference_flops():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(SMALL), ",".join(ARCHS),
                           ",".join(KINDS)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_chip_meta_flops_agree_with_reference_hlo(reference_flops, arch, shape):
    cfg, plan = _plan(get_smoke_config(arch), shape)
    got = dryrun.count_step(cfg, plan)["flops"]
    want = reference_flops[f"{arch}/{shape}"]
    rtol = FLOP_RTOL if (arch, shape) == ("dbrx-132b", "train_4k") else 0.0
    assert want > 0
    assert abs(got - want) <= rtol * want, (got, want, got / want)


def test_the_command_line_counts_a_pair_and_writes_it(tmp_path, capsys):
    assert dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    line = capsys.readouterr().out
    assert "[ok] granite-8b" in line and "1 of 1 pairs counted in" in line
    (path,) = tmp_path.glob("granite-8b__decode_32k__1.json")
    report = json.loads(path.read_text())
    assert report["chips"] == 1 and report["counted_flops"] > 0
    assert report["card"] == dryrun.DEFAULT_CARD
    with pytest.raises(KeyError, match="no peaks"):
        dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k", "--card", "a TPU"])


def test_sweep_pairs_leave_out_llama_as_the_reference():
    pairs = dryrun.sweep_pairs()
    assert len(pairs) == 10 * len(INPUT_SHAPES)
    assert not any(a == "llama3.2-1b" for a, _ in pairs)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_flash_and_slstm_wrappers_take_the_plain_version_off_the_card(device):
    """On ``meta`` (shapes only) and the CPU, B7's and B8's wrappers run
    their plain versions and count no launch; a CUDA tensor launches the
    kernel or raises (``tests/test_torch_cuda.py``)."""
    ops.reset_launch_counts()
    q = torch.zeros((1, 4, 128, 64), device=device)
    k = torch.zeros((1, 2, 128, 64), device=device)
    out = flash_attention(q, k, k, causal=True)
    assert out.device.type == device and tuple(out.shape) == (1, 4, 128, 64)
    gx = torch.zeros((2, 8, 4, 64), device=device)
    r = torch.zeros((4, 2, 32, 32), device=device)
    h, state = slstm_scan(gx, r, num_heads=2, chunk=8)
    assert h.device.type == device and tuple(h.shape) == (2, 8, 64)
    assert [tuple(s.shape) for s in state] == [(2, 2, 32)] * 4
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
