"""State-dict utilities: flatten/unflatten, byte accounting, and the
numpy <-> torch boundary.

Mirror of ``src/repro/utils/trees.py`` with dict/list recursion in place
of ``jax.tree_util``. The FL message layer works on *state dicts* — flat
``{dotted.name: tensor}`` mappings with keys sorted at each level, the
unit of container streaming. The names and the layout (stacked layer
axis first, ``(d_in, d_out)`` weights) are the reference's exactly:
blockwise quantization runs over the flattened tensor, so any other
layout would change the wire bytes.

Tensors live on the device; the wire boundary is numpy.
:func:`as_tensor` / :func:`as_numpy` cross it, and
:func:`from_reference_state` carries the reference package's numpy
state dict into the port.
"""
from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

SEP = "."

_NP_OF_TORCH = {
    torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
    torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
    torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
    torch.uint32: np.uint32,   # the secure-mask grid on the wire
}
_TORCH_OF_NP = {np.dtype(v): k for k, v in _NP_OF_TORCH.items()}


def numpy_dtype(dtype: Any) -> np.dtype:
    """numpy dtype of a torch or numpy dtype (raises for types numpy lacks,
    e.g. bfloat16)."""
    if isinstance(dtype, torch.dtype):
        try:
            return np.dtype(_NP_OF_TORCH[dtype])
        except KeyError:
            raise TypeError(f"{dtype} has no numpy counterpart on the wire") from None
    return np.dtype(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TORCH_OF_NP[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"numpy dtype {np.dtype(dtype)} has no torch counterpart") from None


def as_tensor(value: Any, device: Any) -> torch.Tensor:
    """A torch tensor of ``value`` on ``device``. numpy input is viewed,
    not copied, when ``device`` is the CPU — including read-only wire
    buffers, which callers must then not write into."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if not arr.flags.c_contiguous:   # (ascontiguousarray would make a 0-d array 1-d)
        arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        t = torch.from_numpy(arr)
    else:
        # frombuffer views of received wire bytes are read-only; torch
        # warns about aliasing them. The port reads them only.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
    return t.to(device)


def as_numpy(value: Any) -> np.ndarray:
    """A numpy array of ``value`` (one device-to-host copy for a device tensor)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def tree_leaves(tree: Any) -> list[Any]:
    """Leaves of a nested dict/list/tuple in flatten order (keys sorted)."""
    return list(flatten_state_dict(tree).values())


def tree_bytes(tree: Any) -> int:
    """Total payload bytes of every leaf array/tensor in ``tree``."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def flatten_state_dict(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a nested dict of tensors to ``{dotted.name: tensor}``.

    Ordering is deterministic (sorted at each level) so that sender and
    receiver agree on the container-streaming item order without
    negotiation.
    """
    out: dict[str, Any] = {}

    def rec(node: Any, path: str) -> None:
        if isinstance(node, Mapping):
            for key in sorted(node.keys()):
                sub = f"{path}{SEP}{key}" if path else str(key)
                rec(node[key], sub)
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                sub = f"{path}{SEP}{i}" if path else str(i)
                rec(item, sub)
        else:
            out[path if path else "_"] = node

    rec(tree, prefix)
    return out


def unflatten_state_dict(flat: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`flatten_state_dict` (int-keyed levels with
    contiguous keys come back as lists)."""
    nested: dict[str, Any] = {}
    for name, value in flat.items():
        parts = name.split(SEP)
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def fix_lists(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [fix_lists(node[str(i)]) for i in idx]
        return {k: fix_lists(v) for k, v in node.items()}

    return fix_lists(nested)


def check_state(
    flat: Mapping[str, Any],
    expect: Optional[Mapping[str, tuple[tuple[int, ...], torch.dtype]]] = None,
) -> None:
    """Raise ``ValueError`` unless ``flat`` is a flat state dict of numpy
    arrays or tensors with dotted names — and, when ``expect`` maps each
    name to its ``(shape, dtype)``, exactly those names, shapes and dtypes."""
    if expect is not None and set(flat) != set(expect):
        missing = sorted(set(expect) - set(flat))
        extra = sorted(set(flat) - set(expect))
        raise ValueError(f"state dict names differ: missing {missing}, unexpected {extra}")
    for name, value in flat.items():
        if not isinstance(value, (np.ndarray, torch.Tensor)):
            raise ValueError(f"{name!r} is a {type(value).__name__}, not an array")
        if not name or any(not part for part in name.split(SEP)):
            raise ValueError(f"{name!r} is not a dotted state-dict path")
        if expect is not None:
            shape, dtype = expect[name]
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f"{name!r} has shape {tuple(value.shape)}, "
                                 f"expected {tuple(shape)}")
            if torch_dtype(value.dtype) != dtype:
                raise ValueError(f"{name!r} has dtype {value.dtype}, expected {dtype}")


def from_reference_state(
    flat_np: Mapping[str, np.ndarray], device: Any,
    expect: Optional[Mapping[str, tuple[tuple[int, ...], torch.dtype]]] = None,
) -> dict[str, torch.Tensor]:
    """The reference package's flat numpy state dict
    (``repro.fl.job.initial_weights(spec)`` through ``np.asarray``) as the
    port's flat tensor dict on ``device``, same names in sorted order.

    Raises ``ValueError`` on any mismatch (see :func:`check_state`):
    values that are not numpy arrays, names that are not dotted paths,
    and — when ``expect`` is given (e.g. from ``DecoderLM.param_shapes``)
    — a missing or extra name, a shape or a dtype that differs.
    """
    for name, arr in flat_np.items():
        if not isinstance(arr, np.ndarray):
            raise ValueError(f"{name!r} is a {type(arr).__name__}, not a numpy array")
    check_state(flat_np, expect)
    return {name: torch.tensor(flat_np[name], device=device) for name in sorted(flat_np)}
