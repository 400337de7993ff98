"""Port parity, the roofline: ``repro_torch.launch.roofline`` against
``repro.launch.roofline`` and ``repro.utils.hlo``.

* ``model_flops`` equals the reference's exactly, for all eleven archs and
  the four shapes (its variant applied).
* The ring model of collective wire bytes equals the reference's HLO
  counter on modules that hold one collective each, at group sizes 2,
  4, 8 and 16.
* The peaks: one table keyed by the card's name; an unknown name raises;
  the step's dtype and the TF32 setting choose the compute peak (fp32
  with TF32 off — how the port trains and serves — is the CUDA cores').
* ``analyze``'s terms and bottleneck; ``chip_smoke.py`` takes its peaks
  from this module, and its kernel bounds are what they were.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.utils import hlo as ref_hlo  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import roofline, specs  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("shape", tuple(specs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference_exactly(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    plan, rplan = specs.plan_for(cfg, shape), ref_specs.plan_for(rcfg, shape)
    cfg, rcfg = specs.apply_variant(cfg, plan), ref_specs.apply_variant(rcfg, rplan)
    got = roofline.model_flops(cfg, plan.kind, plan.seq_len, plan.global_batch)
    want = ref_roofline.model_flops(rcfg, rplan.kind, rplan.seq_len, rplan.global_batch)
    assert got == want and got > 0


HLO = """HloModule m

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (p: f32[{n}]) -> f32[{m}] {
  %p = f32[{n}]{0} parameter(0)
  ROOT %c = f32[{m}]{0} {op}(f32[{n}]{0} %p), {attrs}
}
"""
OPS = {
    "all-reduce": ("all-reduce", "to_apply=%add"),
    "all-gather": ("all-gather", "dimensions={0}"),
    "reduce-scatter": ("reduce-scatter", "dimensions={0}, to_apply=%add"),
    "all-to-all": ("all-to-all", "dimensions={0}"),
    "collective-permute": ("collective-permute", "source_target_pairs={{0,1}}"),
}


@pytest.mark.parametrize("group", [2, 4, 8, 16])
@pytest.mark.parametrize("kind", sorted(OPS))
def test_collective_wire_bytes_equal_the_reference_counter(kind, group):
    op, attrs = OPS[kind]
    n = 4096
    m = {"all-gather": n * group, "reduce-scatter": n // group}.get(kind, n)
    groups = "replica_groups={{" + ",".join(str(i) for i in range(group)) + "}}"
    text = (HLO.replace("{n}", str(n)).replace("{m}", str(m)).replace("{op}", op)
            .replace("{attrs}", f"{groups}, {attrs}"))
    stats = ref_hlo.collective_stats(text)
    assert set(stats) == {kind}, stats
    want = stats[kind]["wire_bytes"]
    assert roofline.collective_wire_bytes(kind, 4 * m, group) == want


def test_peaks_come_from_one_table_keyed_by_the_card_name():
    peaks = roofline.peaks_for(H100)
    assert peaks is roofline.PEAKS[H100] is roofline.H100_SXM
    assert (peaks.hbm_bytes_per_s, peaks.fp32_flops, peaks.tf32_flops, peaks.bf16_flops,
            peaks.link_bytes_per_s) == (3.35e12, 67e12, 495e12, 989e12, 450e9)
    with pytest.raises(KeyError, match="no peaks"):
        roofline.peaks_for("TPU v5 lite")
    assert roofline.compute_peak(peaks, torch.float32, tf32=False) == 67e12
    assert roofline.compute_peak(peaks, torch.float32, tf32=True) == 495e12
    assert roofline.compute_peak(peaks, torch.bfloat16, tf32=False) == 989e12
    with pytest.raises(ValueError):
        roofline.compute_peak(peaks, torch.int8, tf32=False)


def test_analyze_terms_and_bottleneck():
    cfg = get_config("llama3.2-1b")
    coll = {"all-gather": {"count": 2.0, "result_bytes": 8.0e9, "wire_bytes": 9.0e9}}
    kw = dict(arch="llama3.2-1b", shape="train_4k", mesh_name="16x16", variant="paper",
              chips=256, cfg=cfg, kind="train", seq_len=4096, global_batch=256,
              card=H100, tf32=False)
    r = roofline.analyze(flops=6.7e12, bytes_accessed=6.7e11, collectives=coll,
                         dtype=torch.float32, **kw)
    assert r.compute_s == pytest.approx(0.1) and r.memory_s == pytest.approx(0.2)
    assert r.collective_s == pytest.approx(0.02) and r.bottleneck == "memory"
    assert r.model_flops == roofline.model_flops(cfg, "train", 4096, 256)
    assert r.useful_flop_ratio == pytest.approx(r.model_flops / (6.7e12 * 256))
    r = roofline.analyze(flops=9.89e14, bytes_accessed=0.0, collectives={},
                         dtype=torch.bfloat16, **kw)
    assert r.compute_s == pytest.approx(1.0) and r.bottleneck == "compute"
    assert set(r.to_dict()) >= {"counted_flops", "counted_bytes", "collective_wire_bytes",
                                "card", "compute_peak_flops", "memory_per_device"}


def test_chip_smoke_takes_its_peaks_from_the_roofline():
    import chip_smoke
    assert chip_smoke.HBM_BYTES_PER_S is roofline.HBM_BYTES_PER_S
    assert chip_smoke.FP32_OPS_PER_S is roofline.FP32_OPS_PER_S
    assert chip_smoke.TF32_OPS_PER_S is roofline.TF32_OPS_PER_S
    assert chip_smoke.BF16_OPS_PER_S is roofline.BF16_OPS_PER_S
    # the kernel table's bounds do not move: 3.35e12 bytes in 1 s; 67e12
    # fp32 operations in 1 s; tf32 + bf16 attention as before
    assert chip_smoke.bound(3.35e12, 0.0) == (1000.0, "bytes")
    assert chip_smoke.bound(0.0, 67e12) == (1000.0, "operations")
    assert chip_smoke.flash_tensor_ops(64, 10) == 4 * 64 * 10 + 8 * 64 * 10 * 495e12 / 989e12
