"""Port parity, ``checkpoint/streaming_ckpt.py`` against
``repro.checkpoint``: checkpoint files are the wire item format at rest,
so every comparison here is bitwise.

* ``save_checkpoint`` writes the reference's bytes for fp32, blockwise8,
  nf4 and fp16 at rest (integer items stay raw).
* Each package loads the other's file, quantized items dequantized, to
  the same bits; ``load_checkpoint`` rebuilds the nested tree and
  ``load_checkpoint_streaming`` hands over every item.
* Server state: pruned to the newest ``keep`` rounds, the meta JSON is
  the commit point (torn leftovers are skipped), weights load flat, and
  each package resumes from the other's state directory.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import streaming_ckpt as ref_ckpt  # noqa: E402
from repro_torch.checkpoint import streaming_ckpt as ckpt  # noqa: E402


def _tree():
    rng = np.random.default_rng(0)
    return {"blocks": {"wq": rng.standard_normal((2, 70, 100)).astype(np.float32),
                       "norm": rng.standard_normal((2, 100)).astype(np.float32)},
            "embed": rng.standard_normal(5000).astype(np.float32) * 3,
            "step": np.arange(6, dtype=np.int32)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _flat_np(flat):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flat.items()}


@pytest.mark.parametrize("fmt", [None, "blockwise8", "nf4", "fp16"])
def test_checkpoint_files_are_the_reference_bytes_and_cross_load(fmt, tmp_path):
    tree = _tree()
    port_path, ref_path = tmp_path / "port.ckpt", tmp_path / "ref.ckpt"
    n = ckpt.save_checkpoint(str(port_path), _as_torch(tree), fmt=fmt)
    assert ref_ckpt.save_checkpoint(str(ref_path), tree, fmt=fmt) == n
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert ckpt.save_checkpoint(str(tmp_path / "np.ckpt"), tree, fmt=fmt) == n
    assert (tmp_path / "np.ckpt").read_bytes() == ref_path.read_bytes()
    ref_flat = dict(ref_ckpt.iter_checkpoint(str(port_path)))
    port_flat = dict(ckpt.iter_checkpoint(str(ref_path), "cpu"))
    assert list(port_flat) == list(ref_flat)
    for k, v in _flat_np(port_flat).items():
        want = np.asarray(ref_flat[k])
        assert v.dtype == want.dtype and v.shape == want.shape
        assert v.tobytes() == want.tobytes(), k
    nested = ckpt.load_checkpoint(str(ref_path), "cpu")
    assert set(nested) == {"blocks", "embed", "step"}
    assert nested["step"].dtype == torch.int32
    got = []
    assert ckpt.load_checkpoint_streaming(str(ref_path), lambda k, v: got.append(k),
                                          "cpu") == 4
    assert got == list(port_flat)


def test_server_state_is_atomic_pruned_torn_tolerant_and_cross_loads(tmp_path):
    w = {"a.b": np.arange(6, dtype=np.float32), "c": np.ones(3, np.int32)}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for rnd in range(5):
        ckpt.save_server_state(str(port_dir), rnd, tw, meta={"roster": ["site-0"]}, keep=3)
        ref_ckpt.save_server_state(str(ref_dir), rnd, w, meta={"roster": ["site-0"]}, keep=3)
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir()) == [
        "round_000002.ckpt", "round_000002.json",
        "round_000003.ckpt", "round_000003.json",
        "round_000004.ckpt", "round_000004.json"]
    for name in names:
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes()
    (port_dir / "round_000005.json").write_text("{not json")
    (ref_dir / "round_000006.json").write_text('{"round": 6, "weights": "gone.ckpt"}')
    for state in (ckpt.latest_server_state(str(port_dir), "cpu"),
                  ckpt.latest_server_state(str(ref_dir), "cpu"),
                  ref_ckpt.latest_server_state(str(port_dir))):
        assert state["round"] == 4 and state["meta"]["roster"] == ["site-0"]
        assert list(state["weights"]) == ["a.b", "c"]    # flat, dotted names intact
        for k, v in _flat_np(state["weights"]).items():
            assert v.tobytes() == w[k].tobytes() and v.dtype == w[k].dtype
    assert ckpt.latest_server_state(str(tmp_path / "missing"), "cpu") is None
