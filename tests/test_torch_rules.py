"""Rule guards for the PyTorch port.

* The port (``src/repro_torch``), ``chip_smoke.py`` and the port's
  examples (``examples/torch``) import neither
  ``jax`` nor anything of the JAX package ``repro``: checked by scanning
  the sources, and by importing the port's entry point in a fresh
  interpreter whose import system refuses both.
* Entry points default to CUDA and raise without it; they never carry on
  quietly on the CPU.
* Kernel wrappers have no ``try``/``except`` that could fall back from
  the card to the plain version.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$|,)", re.MULTILINE)


def _port_sources() -> list[Path]:
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples" / "torch").glob("*.py")))


def test_port_sources_never_import_jax_or_the_reference():
    files = _port_sources()
    assert len(files) > 20, files
    offenders = []
    for path in files:
        for m in FORBIDDEN.finditer(path.read_text()):
            line = path.read_text()[: m.start()].count("\n") + 1
            offenders.append(f"{path.relative_to(ROOT)}:{line}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import repro.core",
                "from repro.kernels import ops", "from repro import fl",
                "  import jax.numpy as jnp", "import repro"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import pipeline",
               "# like repro.core.pipeline", "x = 'import jax'"):
        assert not FORBIDDEN.search(ok), ok


def test_entry_point_imports_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, sys.argv[1])
        sys.path.insert(0, sys.argv[2])
        import runpy
        import repro_torch.fl.job
        import repro_torch.core.filters
        import repro_torch.core.pipeline
        import repro_torch.core.streaming
        import repro_torch.kernels.ops
        import repro_torch.launch.serve
        import repro_torch.launch.fl_train
        import repro_torch.core.collectives
        import repro_torch.models.ssm
        import chip_smoke
        sys.argv = ["repro_torch.fl.job", "--help"]
        try:   # the command-line entry point, as python -m runs it
            runpy.run_module("repro_torch.fl.job", run_name="__main__")
        except SystemExit as exc:
            assert exc.code == 0, exc.code
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), str(ROOT)],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_run_job_without_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.fl.job import build_job, run_job
    spec = {"arch": "llama3.2-1b", "smoke": True, "rounds": 1, "clients": 1}
    for call in (lambda: run_job(spec), lambda: build_job(spec),
                 lambda: build_pipeline(["quantize:blockwise8"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_fl_train_without_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    from repro_torch.launch import fl_train
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_train.main(["--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_train.main(["--smoke", "--rounds", "1", "--backend", "gloo"])


def test_every_launch_counter_is_listed_in_ops_kernels():
    """Every wrapper of ``kernels/`` that counts launches (``fn.launches +=
    1``) is listed in ``ops.KERNELS``, every listed one has an integer
    counter, and every module that launches a kernel counts."""
    import ast
    import importlib

    from repro_torch.kernels import ops
    counted = []
    for path in sorted((PORT / "kernels").glob("*.py")):
        module = importlib.import_module(f"repro_torch.kernels.{path.stem}")
        tree = ast.parse(path.read_text())
        names = [ast.unparse(node.target.value) for node in ast.walk(tree)
                 if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Attribute)
                 and node.target.attr == "launches"]
        launches = "_build.launch(" in path.read_text()
        assert bool(names) == launches, path.name
        counted += [getattr(module, name) for name in names]
    assert len(counted) == len(ops.KERNELS) == 8, counted
    assert {id(fn) for fn in counted} == {id(fn) for fn in ops.KERNELS.values()}
    for name, fn in ops.KERNELS.items():
        assert isinstance(fn.launches, int), name


def test_kernel_wrappers_have_no_fallback_handlers():
    for name in ("quant_blockwise8.py", "quant_nf4.py", "fused_dequant_agg.py",
                 "flash_attention.py", "slstm_scan.py", "ops.py", "../core/collectives.py",
                 "../models/ssm.py"):
        src = (PORT / "kernels" / name).read_text()
        assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE), name


def test_sdpa_or_flash_on_cpu_tensors_never_launches():
    """On CPU tensors the model's attention takes the masked softmax at any
    length, multiples of 128 included, and counts no launch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    cfg = get_smoke_config("llama3.2-1b")
    hd = cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(0)
    ops.reset_launch_counts()
    for s, window in ((128, None), (256, 64), (100, None)):
        q = torch.randn((1, s, cfg.num_heads, hd), generator=gen)
        k = torch.randn((1, s, cfg.num_kv_heads, hd), generator=gen)
        v = torch.randn((1, s, cfg.num_kv_heads, hd), generator=gen)
        out = L.sdpa_or_flash(q, k, v, cfg, causal=True, window=window)
        assert tuple(out.shape) == (1, s, cfg.num_heads * hd)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


ASYNC_MODULES = ("repro_torch.runtime", "repro_torch.runtime.events",
                 "repro_torch.runtime.network", "repro_torch.runtime.async_agg",
                 "repro_torch.runtime.scheduler", "repro_torch.core.secure_agg")


def test_async_runtime_and_secure_agg_import_neither_jax_nor_the_reference():
    """The async runtime and secure aggregation, imported in a fresh
    interpreter whose import system refuses ``jax`` and ``repro``."""
    code = textwrap.dedent("""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, sys.argv[1])
        for mod in sys.argv[2:]:
            importlib.import_module(mod)
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), *ASYNC_MODULES],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    for mod in ASYNC_MODULES:
        path = PORT.joinpath(*mod.split(".")[1:])
        src = (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")).read_text()
        assert not FORBIDDEN.search(src), mod


def test_launch_counters_are_exact_under_threads(monkeypatch):
    """8 threads x 1000 launches through the blockwise8 quantize wrapper
    count 8000. The kernel call and the CUDA-tensor check are stubbed (no
    card here), so meta tensors take the wrapper's launch branch, as a
    CUDA tensor does."""
    import threading

    from repro_torch.kernels import _build, ops, quant_blockwise8
    monkeypatch.setattr(_build, "launch", lambda *a, **k: None)
    monkeypatch.setattr(quant_blockwise8, "check_blocks", lambda *a, **k: None)
    x = torch.empty((1, 4096), dtype=torch.float32, device="meta")
    ops.reset_launch_counts()
    start = threading.Barrier(8)
    errors = []

    def work():
        try:
            start.wait(timeout=30)
            for _ in range(1000):
                quant_blockwise8.quantize_blockwise8(x)
        except Exception as exc:  # reported below: a thread cannot raise into the test
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    assert counts["quantize_blockwise8"] == 8000
    assert sum(counts.values()) == 8000


LIVE_MODULES = ("repro_torch.launch.federation", "repro_torch.core.resilience",
                "repro_torch.checkpoint", "repro_torch.checkpoint.streaming_ckpt")


def test_live_plane_imports_with_jax_and_reference_blocked():
    """The live plane, its transport and checkpoints, and its command
    line (``--help``, as ``python -m`` runs it), in a fresh interpreter
    whose import system refuses ``jax`` and ``repro``."""
    code = textwrap.dedent("""
        import importlib, runpy, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, sys.argv[1])
        for mod in sys.argv[2:]:
            importlib.import_module(mod)
        sys.argv = ["repro_torch.launch.federation", "--help"]
        try:
            runpy.run_module("repro_torch.launch.federation", run_name="__main__")
        except SystemExit as exc:
            assert exc.code == 0, exc.code
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), *LIVE_MODULES],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_run_live_federation_without_device_raises_on_a_cpu_only_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    from repro_torch.checkpoint import iter_checkpoint, save_checkpoint
    from repro_torch.launch import federation as fed
    spec = {"arch": "llama3.2-1b", "smoke": True, "rounds": 1, "clients": 1}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    ckpt = tmp_path / "w.ckpt"
    save_checkpoint(str(ckpt), {"w": np.zeros(4, np.float32)})
    for call in (lambda: fed.run_live_federation(spec, spawn=False),
                 lambda: fed.FederationServer(spec),
                 lambda: fed.FederationClient.for_spec(spec, 0, ("127.0.0.1", 1)),
                 lambda: fed.reference_run(spec, [["site-0"]]),
                 lambda: fed.main(["--spec", str(path), "--no-spawn"]),
                 lambda: list(iter_checkpoint(str(ckpt)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
