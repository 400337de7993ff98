"""The reference's examples (``examples/*.py``) and their ports
(``examples/torch/*.py``), loaded by path without editing either, and
their printed output captured."""
from __future__ import annotations

import contextlib
import importlib.util
import io
import re
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parents[1]
#: a run's wall seconds as the examples print them, "(0.12s)" or "in 1.4s"
SECONDS = re.compile(r"\d+\.\d+s\b")


def load(name: str, port: bool) -> Any:
    """``examples/<name>.py`` (or its port under ``examples/torch``) as a
    fresh module: each load has its own module constants to patch."""
    path = ROOT / "examples" / ("torch" if port else "") / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{'port' if port else 'ref'}_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def captured(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[Any, str]:
    """``fn(*args, **kwargs)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()
