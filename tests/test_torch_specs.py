"""Port parity, dry-run specs: ``repro_torch.launch.specs`` and the models'
logical axes against ``repro.launch.specs`` at full width, for all eleven
archs x the four input shapes, with and without the sliding-window
variant. Shapes only: the reference's stand-ins are ``jax.ShapeDtypeStruct``
(``jax.eval_shape`` of ``init`` and ``init_cache``), the port's are meta
tensors. Held equal:

* ``plan_for``'s fields and ``apply_variant``'s config, field by field;
* ``input_specs``: the same names, shapes and dtypes (the decode cache
  included);
* ``params_specs``: the same flat names, shapes and dtypes;
* ``param_axes()`` and ``cache_axes()``: the same logical axes per leaf.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import create_model as ref_create_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import create_model  # noqa: E402
from repro_torch.utils.trees import numpy_dtype  # noqa: E402

SHAPES = tuple(specs.INPUT_SHAPES)


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict (tuples of axes are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _meta(tree):
    return {k: (tuple(v.shape), np.dtype(numpy_dtype(v.dtype)).name)
            for k, v in _flat(tree).items()}


def _sds(tree):
    flat = {jax.tree_util.keystr(path, simple=True, separator="."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    return {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in flat.items()}


def _fields(cfg) -> dict:
    return {f.name: (str(v).replace("torch.", "") if f.name.endswith("dtype") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


def _ref_fields(cfg) -> dict:
    return {f.name: (np.dtype(v).name if f.name.endswith("dtype") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


def test_the_tables_are_the_references():
    assert specs.INPUT_SHAPES == ref_specs.INPUT_SHAPES
    assert specs.SWA_WINDOW == ref_specs.SWA_WINDOW
    assert specs.SUBQUADRATIC_FAMILIES == ref_specs.SUBQUADRATIC_FAMILIES


@pytest.mark.parametrize("allow_swa", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_variant_and_inputs_equal_reference(arch, shape, allow_swa):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    plan, rplan = specs.plan_for(cfg, shape, allow_swa=allow_swa), \
        ref_specs.plan_for(rcfg, shape, allow_swa=allow_swa)
    assert dataclasses.asdict(plan) == dataclasses.asdict(rplan)
    vcfg, rvcfg = specs.apply_variant(cfg, plan), ref_specs.apply_variant(rcfg, rplan)
    assert _fields(vcfg) == _ref_fields(rvcfg)
    assert _meta(specs.input_specs(vcfg, plan)) == _sds(ref_specs.input_specs(rvcfg, rplan))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_specs_and_axes_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    got = _meta(specs.params_specs(cfg))
    assert got == _sds(ref_specs.params_specs(rcfg))
    axes = _flat(create_model(cfg).param_axes())
    ref_axes = _flat(ref_create_model(rcfg).param_axes())
    assert axes == ref_axes
    assert set(axes) == set(got)
    for name, (shape, _dtype) in got.items():
        assert len(axes[name]) == len(shape), name
    assert all(t.device.type == "meta" for t in _flat(specs.params_specs(cfg)).values())


@pytest.mark.parametrize("variant", ["paper", "swa"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_equal_reference_per_leaf(arch, variant):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    if variant == "swa":
        cfg = cfg.with_overrides(sliding_window=specs.SWA_WINDOW)
        rcfg = rcfg.with_overrides(sliding_window=ref_specs.SWA_WINDOW)
    axes = _flat(create_model(cfg).cache_axes())
    assert axes == _flat(ref_create_model(rcfg).cache_axes())
    cache = _flat(create_model(cfg).init_cache(2, 64, "meta"))
    assert set(cache) == set(axes)
    for name, t in cache.items():
        assert len(axes[name]) == t.ndim, name
