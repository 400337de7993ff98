"""Plain references of the benchmark's configurations.

A configuration file names its reference under ``reference``: the path,
from the root of the tree, of a ``.py`` file in this directory, such as
``fedbench/reference/decoder.py``. :func:`load` finds it there and
refuses any other path, so that every reference lies where the
benchmark's import guard reads it: plain PyTorch or NumPy, importing
neither JAX nor the JAX package nor anything of the program.

A reference module exports, for a configuration ``cfg`` (the dict of
its file):

``param_specs(cfg)``
    ``{flat name: (shape, init)}`` in sorted name order: the leaves the
    wire carries, by the program's flat names.
``param_count(cfg)``
    the number of parameters, which the file states as ``params``.
``make_weights(cfg, seed, device)``
    the round-0 global weights from the seed, float32 tensors on
    ``device`` by flat name; the same seed gives the same numbers.
``loss(params, tokens, cfg, precision)``
    the training loss of a ``(batch, seq)`` int64 token batch,
    differentiable in ``params``; ``precision`` is ``"fp32"``, as the
    configurations state, or ``"tf32"``, the control.
``train_flops_per_step(cfg, batch, seq)``
    the model FLOPs of one local step, forward and backward, with no
    recompute.
"""
from __future__ import annotations

from typing import Any

from fedbench import loader

HOME = "fedbench/reference"
EXPORTS = ("param_specs", "param_count", "make_weights", "loss", "train_flops_per_step")

_loaded: dict[Any, Any] = {}


def load(cfg: dict[str, Any]) -> Any:
    """The reference module that ``cfg["reference"]`` names, under the
    root of the cell's tree (``cfg["root"]``, which :class:`fedbench.harness.Cell`
    sets) or of this one; loaded once a path."""
    path = loader.python_file_under(cfg.get("root", loader.TREE), cfg["reference"], HOME)
    if path not in _loaded:
        mod = loader.load_file(path, f"fedbench_reference_{path.stem}")
        missing = [name for name in EXPORTS if not callable(getattr(mod, name, None))]
        if missing:
            raise ValueError(f"reference {cfg['reference']!r} does not export {missing}")
        _loaded[path] = mod
    return _loaded[path]
