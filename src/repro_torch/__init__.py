"""PyTorch / CUDA port of the ``repro`` federated-learning package.

Mirrors ``src/repro`` module for module where a counterpart is ported,
keeps its parameter names, layouts and wire format, and runs the
blockwise-int8 message path through hand-written CUDA kernels for
Hopper (``kernels/csrc``). Imports ``torch`` and numpy only — never
``jax`` and never ``repro``.
"""
