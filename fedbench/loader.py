"""Python files of the benchmark loaded as modules by their path: a
cell's metric readers and its configuration's plain reference, each
found by the name or the path that the benchmark's files give."""
from __future__ import annotations

import importlib.util
import types
from pathlib import Path

#: the root of the tree this package lies in
TREE = Path(__file__).resolve().parents[1]


def load_file(path: Path, name: str) -> types.ModuleType:
    """The Python file at ``path``, run as a new module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path} as a module")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def python_file_under(root: Path | str, rel: str, home: str) -> Path:
    """``root / rel`` resolved, where it is a ``.py`` file inside
    ``root / home``; ``ValueError`` for any other path (absolute, out
    through ``..``, elsewhere in the tree, not Python, missing)."""
    base = Path(root).resolve()
    path = (base / rel).resolve()
    if Path(rel).is_absolute() or path.suffix != ".py" \
            or not path.is_relative_to(base / home):
        raise ValueError(f"{rel!r} is not a .py file under {home}/")
    if not path.is_file():
        raise ValueError(f"{rel!r}: no such file under {base}")
    return path
