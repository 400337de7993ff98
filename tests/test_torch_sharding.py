"""Port parity, sharding rules: ``repro_torch.launch.sharding.spec_for``
against ``repro.launch.sharding.spec_for`` at full width, for every
parameter, decode-cache leaf and input of all eleven archs, on meshes
(16, 16), (2, 16, 16) and (2, 4), under both rule sets.

The reference's ``spec_for`` reads only a mesh's ``axis_names`` and
``shape``, so a stand-in serves and no devices are faked. Held equal: the
``PartitionSpec`` entries, one per dim (None, a mesh axis, or a tuple of
mesh axes). Then, on a fake process group of 256 / 512 / 8 ranks (in a
subprocess: a process group is global to its process), DTensor's own
split of each parameter — ``distribute_tensor`` of a meta tensor with
:func:`placements` — gives the shard shape those entries imply, a dim
over two mesh axes (batch over ``("pod", "data")``) included.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import create_model as ref_create_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import sharding, specs  # noqa: E402
from repro_torch.models import create_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
RULES = {"default": (sharding.DEFAULT_RULES, ref_sharding.DEFAULT_RULES),
         "tp_only": (sharding.TP_ONLY_RULES, ref_sharding.TP_ONLY_RULES)}


def _meshes(name):
    sizes, names = MESHES[name]
    port = types.SimpleNamespace(mesh_dim_names=names, shape=sizes)
    ref = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    return port, ref


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _batch_axes(ndim):
    from repro_torch.models import base as B
    return (B.BATCH,) + (None,) * (ndim - 1)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equals_reference(arch, mesh, rules):
    port_mesh, ref_mesh = _meshes(mesh)
    port_rules, ref_rules = RULES[rules]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    checked = 0
    params = _flat(specs.params_specs(cfg))
    p_axes = _flat(create_model(cfg).param_axes())
    ref_p_axes = _flat(ref_create_model(rcfg).param_axes())
    for name, t in params.items():
        got = sharding.spec_for(t.shape, p_axes[name], port_mesh, port_rules)
        want = ref_sharding.spec_for(t.shape, ref_p_axes[name], ref_mesh, ref_rules)
        assert got == tuple(want), name
        checked += 1
    for shape in ("decode_32k", "long_500k"):
        plan, rplan = specs.plan_for(cfg, shape), ref_specs.plan_for(rcfg, shape)
        vcfg, rvcfg = specs.apply_variant(cfg, plan), ref_specs.apply_variant(rcfg, rplan)
        axes = _flat(create_model(vcfg).cache_axes())
        ref_axes = _flat(ref_create_model(rvcfg).cache_axes())
        for name, t in _flat(specs.input_specs(vcfg, plan)["cache"]).items():
            got = sharding.spec_for(t.shape, axes[name], port_mesh, port_rules)
            want = ref_sharding.spec_for(t.shape, ref_axes[name], ref_mesh, ref_rules)
            assert got == tuple(want), (shape, name)
            checked += 1
    for shape in specs.INPUT_SHAPES:
        plan = specs.plan_for(cfg, shape)
        for name, t in _flat(specs.input_specs(cfg, plan)).items():
            if name.startswith("cache"):
                continue
            got = sharding.batch_sharding(port_mesh, t.shape, port_rules)
            want = ref_sharding.spec_for(t.shape, _batch_axes(t.ndim), ref_mesh, ref_rules)
            assert got == tuple(want), (shape, name)
            checked += 1
    assert checked > len(params)
    assert sharding.replicated(port_mesh) == tuple(jax.sharding.PartitionSpec())


def test_placements_follow_mesh_order_and_refuse_others():
    from torch.distributed.tensor import Replicate, Shard
    port_mesh, _ = _meshes("2x16x16")
    assert sharding.placements((("pod", "data"), None, "model"), port_mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, "data"), port_mesh) == (Replicate(), Shard(1), Replicate())
    assert sharding.placements((), port_mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("data", "pod"),), port_mesh)
    assert sharding.local_shape((32, 8, 64), (("pod", "data"), None, "model"), port_mesh) == \
        (1, 8, 4)


LOCAL_SHAPES = r"""
import json, math, sys
import torch
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.models import create_model

shape = tuple(json.loads(sys.argv[1]))
checked = bad = 0
with dryrun.fake_process_group(math.prod(shape)):
    mesh = dryrun.make_mesh(shape)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = specs.params_specs(cfg)
        entries = sharding.tree_shardings(params, create_model(cfg).param_axes(), mesh)
        flat = {}
        def walk(p, e):
            for k in p:
                if isinstance(p[k], dict):
                    walk(p[k], e[k])
                else:
                    flat[(arch, id(p[k]))] = (p[k], e[k])
        walk(params, entries)
        batch = torch.empty((256, 4096), dtype=torch.int32, device="meta")
        flat[(arch, "batch")] = (batch, sharding.batch_sharding(mesh, batch.shape))
        for t, e in flat.values():
            local = distribute_tensor(t, mesh, sharding.placements(e, mesh)).to_local()
            checked += 1
            bad += tuple(local.shape) != sharding.local_shape(t.shape, e, mesh)
print(json.dumps({"checked": checked, "bad": bad}))
"""


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dtensor_local_shapes_equal_the_entries_shards(mesh):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", LOCAL_SHAPES, json.dumps(MESHES[mesh][0])],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["checked"] > 200 and out["bad"] == 0, out
