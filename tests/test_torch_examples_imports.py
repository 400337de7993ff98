"""The port's examples (``examples/torch/*.py``) as entry points, and the
package surface they import:

* ``repro_torch.fl`` and ``repro_torch.utils`` re-export what
  ``repro.fl`` and ``repro.utils`` do, name for name, so
  ``from repro_torch.fl import FLSimulator`` works as the reference's
  import does;
* each example imports, and its ``--help`` runs, in an interpreter whose
  import system refuses ``jax`` and ``repro``;
* each example's ``main`` runs on CUDA by default and raises on a host
  without it (``--device cpu`` runs it on the CPU: the parity tests).
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_examples import ROOT, load  # noqa: E402

EXAMPLES = ("quickstart", "streaming_demo", "async_federation", "hetero_federation",
            "serve_batch")


@pytest.mark.parametrize("package", ["fl", "utils"])
def test_packages_re_export_what_the_reference_does(package):
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith(f"repro_torch.{package}."), (name, obj.__module__)


def test_examples_import_with_jax_and_the_reference_blocked():
    code = textwrap.dedent("""
        import os
        import runpy
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        src, examples, names = sys.argv[1], sys.argv[2], sys.argv[3:]
        sys.path.insert(0, src)
        for name in names:
            sys.argv = [name, "--help"]
            try:
                runpy.run_path(os.path.join(examples, f"{name}.py"), run_name="__main__")
            except SystemExit as exc:
                assert exc.code == 0, (name, exc.code)
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"),
                           str(ROOT / "examples" / "torch"), *EXAMPLES],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_runs_on_cuda_by_default_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name, port=True).main([])
