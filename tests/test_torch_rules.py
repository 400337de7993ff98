"""Rule guards for the PyTorch port.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither
  ``jax`` nor anything of the JAX package ``repro``: checked by scanning
  the sources, and by importing the port's entry point in a fresh
  interpreter whose import system refuses both.
* Entry points default to CUDA and raise without it; they never carry on
  quietly on the CPU.
* Kernel wrappers have no ``try``/``except`` that could fall back from
  the card to the plain version.
"""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$|,)", re.MULTILINE)


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        import repro_torch.fl.job
        import repro_torch.core.pipeline
        import repro_torch.kernels.ops
        import chip_smoke
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


def test_kernel_wrappers_have_no_fallback_handlers():
    for name in ("quant_blockwise8.py", "fused_dequant_agg.py", "ops.py"):
        src = (PORT / "kernels" / name).read_text()
        assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE), name
