"""No module of the benchmark imports JAX or the JAX package, and its
plain reference imports nothing of the port either; the measurement path
refuses to run without a CUDA device."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from fedbench.tests.smallcell import ROOT

BENCH = ROOT / "fedbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set[str]:
    """The top-level names (before the first dot, whole) that a module imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {alias.name.split(".", 1)[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "math", "typing", "numpy", "torch", "fedbench"}


def test_guard_compares_whole_names():
    assert "repro_torch" not in FORBIDDEN and "repro_torch".split(".", 1)[0] != "repro"


def test_measurement_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "stablelm-b8-stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
